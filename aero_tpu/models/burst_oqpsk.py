"""Burst OQPSK demodulator (10500 bps C-band R/T channels).

Block-vectorized redesign of the reference's burst OQPSK path
(ref: decode/burstoqpskdemodulator.cpp): the reference detects bursts with a
conjugate-product arm, estimates carrier from 32k "trident" FFTs
(:341-456) and runs a primed per-sample loop with x4-PLL preamble
acquisition (:484-586).  Here each detected burst is demodulated as one
stateless window (see models/burst_common + models/burst_msk for the
detection phase): gated coarse CFO in-window, RRC matched filter, masked
tone-pair sync, OQPSK strobe pairing, straight soft mapping.

Output protocol: int16 stream, -1 start-of-burst marker, soft pairs
[Q(imag), I(real)] per symbol — consumed by protocol/rt_framing with
oqpsk=True (straight 64 x rows interleaver layout, aerol.h:755-836).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aero_tpu.ops import nco_init, nco_mix, fir_apply, fir_init, root_raised_cosine
from aero_tpu.models.msk import _tone_pair_sync
from aero_tpu.models.burst_msk import _gated_coarse_offset
from aero_tpu.models.burst_common import BurstWindowDemodulator


class BurstOqpskConfig(NamedTuple):
    fs: float
    fb: float
    sps: int                   # smoothing-length proxy (int samples/bit)
    block_len: int
    window_len: int
    nfft: int
    lockingbw: float
    freq_center: float
    gate_ratio: float
    fine_span_hz: float
    fine_step_hz: float
    alpha: float
    ntaps: int

    @property
    def strobe_step(self) -> float:
        return self.fs / self.fb


def make_config(fs: float, fb: float, block_len: int = 16000,
                window_len: int | None = None, lockingbw: float = 10500.0,
                freq_center: float = 8000.0, nfft: int = 8192,
                gate_ratio: float = 2.5, fine_span_hz: float | None = None,
                fine_step_hz: float = 0.5) -> BurstOqpskConfig:
    if window_len is None:
        window_len = 3 * block_len
    lockingbw = min(lockingbw, fs / 2.0 - fb)
    if fine_span_hz is None:
        fine_span_hz = 2.0 * fs / nfft + 4.0
    return BurstOqpskConfig(fs, fb, max(1, int(fs / fb)), block_len,
                            window_len, nfft, lockingbw, freq_center,
                            gate_ratio, fine_span_hz, fine_step_hz,
                            0.6 if fb == 8400 else 1.0, 55)


@functools.partial(jax.jit, static_argnames=("cfg",))
def burst_oqpsk_window(samples, gate, cfg: BurstOqpskConfig,
                       freq_center=None):
    if freq_center is None:
        freq_center = jnp.asarray(cfg.freq_center, jnp.float32)
    W = cfg.window_len
    step = cfg.strobe_step
    x = jnp.asarray(samples, jnp.float32)
    gate = jnp.asarray(gate, jnp.float32)

    dil = jnp.ones(8 * cfg.sps, jnp.float32)
    gate = (jnp.convolve(gate, dil, mode="same") > 0).astype(jnp.float32)

    _, bb = nco_mix(nco_init(), x.astype(jnp.complex64),
                    freq_center / cfg.fs, conj=True)
    dfc = _gated_coarse_offset(bb, gate, cfg.nfft, cfg.fb, cfg.fs,
                               cfg.lockingbw)
    n = jnp.arange(W, dtype=jnp.float32)
    bb = bb * jnp.exp(-2j * jnp.pi * (dfc / cfg.fs) * n).astype(jnp.complex64)

    taps = jnp.asarray(root_raised_cosine(cfg.alpha, cfg.ntaps, cfg.fs,
                                          cfg.fb / 2.0), jnp.float32)
    _, y = fir_apply(fir_init(cfg.ntaps, dtype=jnp.complex64), bb, taps)

    gsum = jnp.maximum(jnp.sum(gate), 1.0)
    gmean = jnp.sum(jnp.abs(y) * gate) / gsum
    y = y * (jnp.sqrt(2.0) / jnp.maximum(gmean, 1e-6))
    mag = jnp.abs(y)
    y = jnp.where(mag > 2.84, y * (2.84 / jnp.maximum(mag, 1e-9)), y)

    df, theta0, t0_sym, quality = _tone_pair_sync(
        y * gate.astype(y.dtype), cfg.fb / cfg.fs,
        cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)

    rot = jnp.exp(-1j * (theta0 + 2.0 * jnp.pi * df * n)).astype(jnp.complex64)
    yr = y * rot

    n_pairs = int(W // (2 * step))
    m = jnp.arange(n_pairs, dtype=jnp.float32)

    def interp(sig, p):
        p = jnp.clip(p, 0.0, sig.shape[-1] - 2.0)
        i0 = jnp.floor(p).astype(jnp.int32)
        w = (p - i0).astype(jnp.float32)
        return sig[i0] * (1.0 - w) + sig[i0 + 1] * w

    def pair_points(g):
        pos_q = g + m * (2.0 * step)
        q = interp(yr, pos_q).imag
        i = interp(yr, pos_q + step).real
        gt = interp(gate, pos_q)
        return i, q, gt

    g_raw = jnp.mod(t0_sym * (2.0 * step), 2.0 * step)
    cand = jnp.stack([g_raw, jnp.mod(g_raw + step, 2.0 * step)])

    def eye_mse(g):
        i, q, gt = pair_points(g)
        mean_mag = jnp.sum(jnp.sqrt(i * i + q * q) * gt) / jnp.maximum(jnp.sum(gt), 1.0)
        s = jnp.sqrt(2.0) / jnp.maximum(mean_mag, 1e-6)
        tda = (jnp.abs(i * s) - 1.0) * gt
        tdb = (jnp.abs(q * s) - 1.0) * gt
        return jnp.sum(tda * tda + tdb * tdb) / jnp.maximum(jnp.sum(gt), 1.0)

    grid = jnp.where(eye_mse(cand[0]) <= eye_mse(cand[1]), cand[0], cand[1])
    pt_i, pt_q, gt = pair_points(grid)

    soft = jnp.stack(
        [jnp.clip(jnp.round(0.75 * pt_q * 127.0 + 128.0), 0, 255),
         jnp.clip(jnp.round(0.75 * pt_i * 127.0 + 128.0), 0, 255)], axis=-1)

    return {
        "soft": soft,
        "active": gt > 0.5,
        "freq_offset": dfc + df * cfg.fs,
        "tone_quality": quality,
    }


class BurstOqpskDemodulator(BurstWindowDemodulator):
    def __init__(self, fs: float, fb: float, **kw):
        super().__init__(make_config(fs, fb, **kw), burst_oqpsk_window)
