"""Polyphase (WOLA) filterbank channelizer: all channels in one pass.

The reference channelizes with a per-VFO tree of NCO mixers and halfband
cascades (publish/vfo.cpp) because that is what a per-sample CPU design
affords.  On an accelerator the right structure is a weight-overlap-add
filterbank: window the wideband stream with a long prototype lowpass, fold
into K bins, FFT — every channel of a uniform grid drops out of one dense
pipeline (SURVEY.md §7.4).

Channel k of ``pfb_channelize`` is the input mixed down by k*fs/K, filtered
by the prototype, and decimated by hop M:

    z[k, m] = sum_j h[j] x[mM - j] exp(-2j pi k (mM - j) / K)

With K = 128 and M = K/2 (2x oversampled) at fs = 1.536 MS/s the output
rate is exactly 24 kHz — the native Aero 1200 bps VFO rate — and bin
spacing is 12 kHz; an audio-rate residual mix centers any VFO exactly
(`pfb_extract_vfo`).

All dense: one [F, L] gather, an elementwise window multiply, a fold and a
length-K FFT per hop.  State is the last L-M input samples.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from aero_tpu.ops.design import low_pass_design
from aero_tpu.ops.compat import pack_c64, unpack_c64


@functools.lru_cache(maxsize=None)
def pfb_prototype(K: int, taps_per_branch: int = 8, fs: float = 1.0,
                  cutoff_frac: float = 0.75) -> np.ndarray:
    """Prototype lowpass, length P*K; passband edge at ``cutoff_frac`` of
    the bin spacing fs/K.

    The filterbank is 2x oversampled (hop M = K/2, output Nyquist fs/K),
    so the prototype may pass well beyond half the bin spacing before
    decimation aliasing matters.  The wide 0.75 default keeps the VFO
    audio usable across the full hunting scan range (the reference's VFO
    audio from the SDR is full-band; an off-center 10500 bps carrier at
    14 kHz audio spans ~20 kHz and must survive the PFB —
    tests/test_hunter_station.py).  Stopband starts at 1.2x the bin
    spacing: content folding into the band edge is partially attenuated,
    anything further is >70 dB down; the per-demod matched filters
    provide the final channel selectivity."""
    L = taps_per_branch * K
    cut = cutoff_frac / K
    taps = low_pass_design(1.0, 1.0, cut, 0.45 / K, ntaps=L - 1)
    taps = np.append(taps, 0.0)
    return (taps / np.sum(taps) * K).astype(np.float32)


def pfb_init(K: int, taps_per_branch: int = 8, batch_shape=()):
    L = taps_per_branch * K
    M = K // 2
    return jnp.zeros(batch_shape + (L - M,), jnp.complex64)


@functools.partial(jax.jit, static_argnames=("K", "taps_per_branch"))
def pfb_channelize(state, x, K: int, taps_per_branch: int = 8):
    """x: [T] complex wideband (T % (K//2) == 0).

    Returns (new_state, z [K, T//(K//2)]) — K channels, 2x oversampled,
    channel k centered at k*fs/K (k > K/2 wraps to negative).
    """
    M = K // 2
    L = taps_per_branch * K
    T = x.shape[-1]
    F = T // M

    xp = jnp.concatenate([state, x])              # [T + L - M]
    idx = jnp.arange(L)[None, :] + M * jnp.arange(F)[:, None]
    frames = xp[idx]                              # [F, L]; frame m = x[mM-L+M .. mM+M)

    h = jnp.asarray(pfb_prototype(K, taps_per_branch))
    # z[k,m] = sum_j h[j] x[mM-j] e^{-2pi i k (mM-j)/K}
    #        = e^{-2pi i k mM/K} sum_j h[j] x[mM-j] e^{+2pi i k j/K}
    # frame index: frames[m, i] = xp[mM + i] = x[mM + i - (L - M)]
    # let j = M - 1 - (i - (L - M)) ... implement via reversed window:
    w = frames * h[::-1][None, :]
    folded = w.reshape(F, taps_per_branch, K).sum(axis=1)   # [F, K]
    # with output time n_m = mM + M - 1 (frame's newest sample):
    #   z[k,m] = e^{-2pi i k n_m / K} e^{-2pi i k / K} FFT_k(folded[m])
    #          = e^{-2pi i k (m+1) M / K} FFT_k(folded[m])
    z = jnp.fft.fft(folded, axis=-1)
    m = jnp.arange(F)
    k = jnp.arange(K)
    tw = jnp.exp(-2j * jnp.pi
                 * (k[None, :] * (((m[:, None] + 1) * M) % K)) / K)
    z = z * tw.astype(jnp.complex64)
    new_state = xp[-(L - M):]
    return new_state, jnp.transpose(z)                      # [K, F]


@functools.partial(jax.jit, static_argnames=("K", "taps_per_branch"))
def pfb_channelize_fused(state, x, K: int, taps_per_branch: int = 8):
    """Bit-compatible fast path for ``pfb_channelize`` (M = K//2).

    The reference formulation gathers overlapping [F, L] frames — an
    8x HBM read amplification at taps_per_branch=8.  Here the fold is a
    depthwise 1-D convolution over K-sample rows: because the hop M
    divides K, frames at even/odd hops align to row boundaries of
    ``x.reshape(-1, K)`` and the tap blocks become an
    taps_per_branch-tap filter along the row axis — each wideband
    sample is read once per parity instead of taps_per_branch times.
    """
    from jax import lax
    M = K // 2
    P = taps_per_branch
    L = P * K
    T = x.shape[-1]
    F = T // M
    assert F % 2 == 0, "need an even number of hops per block"

    xp = jnp.concatenate([state, x])              # [T + L - M]
    h = jnp.asarray(pfb_prototype(K, P))
    hrev = h[::-1].reshape(P, K)                  # block c = hrev[cK:(c+1)K]

    Q = F // 2
    rows_e = xp[: (Q + P - 1) * K].reshape(Q + P - 1, K)
    rows_o = xp[M: M + (Q + P - 1) * K].reshape(Q + P - 1, K)

    def fold(rows):
        # depthwise conv over the row axis: out[q] = sum_c hrev[c]*rows[q+c]
        def conv1(r):                             # r: [Q+P-1, K] real
            lhs = r.T[None]                       # [1, K, Q+P-1]
            rhs = hrev.T[:, None, :]              # [K, 1, P]
            y = lax.conv_general_dilated(
                lhs, rhs, window_strides=(1,), padding="VALID",
                dimension_numbers=("NCH", "OIH", "NCH"),
                feature_group_count=K)
            return y[0].T                         # [Q, K]
        return (conv1(rows.real)
                + 1j * conv1(rows.imag)).astype(jnp.complex64)

    folded = jnp.stack([fold(rows_e), fold(rows_o)], axis=1).reshape(F, K)
    z = jnp.fft.fft(folded, axis=-1)
    m = jnp.arange(F)
    k = jnp.arange(K)
    tw = jnp.exp(-2j * jnp.pi
                 * (k[None, :] * (((m[:, None] + 1) * M) % K)) / K)
    z = z * tw.astype(jnp.complex64)
    new_state = xp[-(L - M):]
    return new_state, jnp.transpose(z)            # [K, F]


def pfb_bin_for_freq(freq_hz: float, fs: float, K: int) -> int:
    """Nearest bin index for a baseband frequency (may be negative)."""
    return int(np.round(freq_hz / (fs / K))) % K


@functools.partial(jax.jit, static_argnames=("K",))
def pfb_extract_vfo(z_k, phase, residual_norm, K: int):
    """Residual-mix one PFB channel to center a VFO exactly.

    z_k: [F] channel samples at rate fs/(K//2); residual_norm = residual
    frequency in cycles per OUTPUT sample.  Returns (new_phase, centered
    complex baseband).
    """
    F = z_k.shape[-1]
    n = jnp.arange(F, dtype=jnp.float32)
    ramp = phase + residual_norm * n
    osc = jnp.exp(-2j * jnp.pi * jnp.mod(ramp, 1.0)).astype(jnp.complex64)
    new_phase = jnp.mod(phase + residual_norm * F, 1.0)
    return new_phase, z_k * osc


class PfbChannelizer:
    """Drop-in alternative to ``Channelizer`` for uniform-rate VFO banks.

    Groups sub VFOs by output rate; each group gets one K = 2*fs/out_rate
    filterbank pass, then a vmapped residual mix + real-audio conversion
    per VFO.  Main-VFO IQ topics are not supported here (use the classic
    tree channelizer for those).
    """

    def __init__(self, cfg, audio_center: float = 1000.0, gain: float = 10.0):
        from collections import defaultdict
        self.cfg = cfg
        self.fs = cfg.sample_rate
        self.audio_center = audio_center
        self.gain = gain
        assert not any(m.topic for m in cfg.mains), \
            "PFB backend serves sub-VFO audio only"
        self.groups = defaultdict(list)
        for i, s in enumerate(cfg.subs):
            self.groups[s.out_rate].append(i)
        self._state = {}
        self._phase = {}
        self._params = {}
        for out_rate, idxs in self.groups.items():
            K = int(round(2 * self.fs / out_rate))
            assert abs(2 * self.fs / out_rate - K) < 1e-9, \
                f"out_rate {out_rate} incompatible with fs {self.fs}"
            bins = []
            resid = []
            for i in idxs:
                s = self.cfg.subs[i]
                delta = s.freq - cfg.center_frequency
                k = pfb_bin_for_freq(delta, self.fs, K)
                kc = k if k < K // 2 else k - K
                r = delta - kc * self.fs / K
                bins.append(k)
                # USB-audio convention: audio frequency = signal - rf, so
                # the bin output only needs the -r residual shift
                resid.append(-r / out_rate)
            self._params[out_rate] = (K, np.asarray(bins),
                                      np.asarray(resid, np.float32))
            L = 8 * K
            self._state[out_rate] = jnp.zeros((2, L - K // 2), jnp.float32)
            self._phase[out_rate] = jnp.zeros(len(idxs), jnp.float32)
        self._steps = {}

    def _group_step(self, out_rate):
        """One jitted, complex-free step for a rate group: float-pair
        wideband + packed PFB state in, int16 PCM out (ops/compat.py)."""
        if out_rate not in self._steps:
            K, bins, resid = self._params[out_rate]
            gain = self.gain

            @jax.jit
            def step(state2, x2, phase):
                chan = (pfb_channelize_fused
                        if (x2.shape[-1] // (K // 2)) % 2 == 0
                        else pfb_channelize)
                st, z = chan(unpack_c64(state2), unpack_c64(x2), K)
                zb = z[jnp.asarray(bins)]                    # [B, F]
                F = zb.shape[1]
                n = jnp.arange(F, dtype=jnp.float32)
                ramp = phase[:, None] + jnp.asarray(resid)[:, None] * n
                osc = jnp.exp(2j * jnp.pi * jnp.mod(ramp, 1.0)
                              ).astype(jnp.complex64)
                new_phase = jnp.mod(phase + jnp.asarray(resid) * F, 1.0)
                audio = (zb * osc).real * gain * 32768.0
                pcm = jnp.clip(audio, -32767.0, 32767.0).astype(jnp.int16)
                return pack_c64(st), new_phase, pcm

            self._steps[out_rate] = step
        return self._steps[out_rate]

    def process(self, iq: np.ndarray) -> list:
        """iq [T] complex64 -> [(topic, out_rate, int16 audio payload), ...]"""
        out = []
        iq = np.asarray(iq, np.complex64)
        x2 = jnp.asarray(np.stack([iq.real, iq.imag]))
        for out_rate, idxs in self.groups.items():
            step = self._group_step(out_rate)
            self._state[out_rate], self._phase[out_rate], pcm = step(
                self._state[out_rate], x2, self._phase[out_rate])
            pcm = np.asarray(pcm)
            for row, i in enumerate(idxs):
                out.append((self.cfg.subs[i].topic, out_rate,
                            pcm[row].astype("<i2").tobytes()))
        return out
