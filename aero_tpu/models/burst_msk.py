"""Burst MSK demodulator (600/1200 bps Aero R/T channels).

Block-vectorized redesign of the reference's burst machinery
(ref: decode/burstmskdemodulator.cpp): the reference detects bursts with a
per-sample autocorrelation arm + PeakDetector and estimates carrier
frequency/phase/amplitude from 32k-point "trident" FFTs per candidate
(:341-492), then runs a primed per-sample demod loop.

Here, burst processing is two-phase and WINDOW-BASED:

  1. detection: a cheap dense per-block step tracks the smoothed signal
     power against a carried noise floor and reports gate runs;
  2. demodulation: each detected burst is extracted (with padding) into one
     fixed-size window and demodulated STATELESSLY by the same feedforward
     pipeline as continuous MSK — gated coarse CFO (applied in-window),
     matched filter, masked squared-signal tone-pair sync, strobe gather,
     differential soft decode.  Because every estimate sees the whole
     burst, there are no block-boundary artifacts and no carried loop
     state at all.

Soft bits come out as int16: 0..255 soft values preceded by a -1
start-of-burst marker (the reference pushes -1 into its soft stream,
burstmskdemodulator.cpp:503-505).  protocol/rt_framing consumes them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from aero_tpu.ops import (nco_init, nco_mix, fir_apply, fir_init,
                          msk_matched_filter)
from aero_tpu.models.msk import _tone_pair_sync


class BurstMskConfig(NamedTuple):
    fs: float
    fb: float
    sps: int
    block_len: int
    window_len: int            # demod window (static shape)
    nfft: int
    lockingbw: float
    freq_center: float
    gate_ratio: float
    fine_span_hz: float
    fine_step_hz: float


def make_config(fs: float, fb: float, block_len: int = 16000,
                window_len: int | None = None,
                lockingbw: float = 10500.0, freq_center: float | None = None,
                nfft: int = 8192, gate_ratio: float = 2.5,
                fine_span_hz: float | None = None,
                fine_step_hz: float = 0.5) -> BurstMskConfig:
    sps = int(fs / fb)
    if window_len is None:
        window_len = 3 * block_len
    assert window_len % (2 * sps) == 0
    lockingbw = min(lockingbw, fs / 2.0 - 2 * fb)
    if freq_center is None:
        freq_center = fs / 4.0
    if fine_span_hz is None:
        fine_span_hz = 2.0 * fs / nfft + 4.0
    return BurstMskConfig(fs, fb, sps, block_len, window_len, nfft,
                          lockingbw, freq_center, gate_ratio, fine_span_hz,
                          fine_step_hz)


# ---------------------------------------------------------------------------
# phase 1: detection
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("smooth",))
def _envelope(samples, smooth: int):
    x = jnp.asarray(samples, jnp.float32)
    p = x * x
    kernel = jnp.ones(smooth, jnp.float32) / smooth
    return jnp.convolve(p, kernel, mode="same")


# ---------------------------------------------------------------------------
# phase 2: stateless window demodulation
# ---------------------------------------------------------------------------

def _gated_coarse_offset(bb, gate, nfft, fb, fs, lockingbw):
    """One-shot fold-spectrum CFO over the gated baseband (same fold as
    models/coarse_freq, no cross-block smoothing — bursts need instant
    estimates; ref trident frequency estimate burstmskdemodulator.cpp:414-492)."""
    x = (bb * gate.astype(bb.dtype))[..., :nfft]
    hzperbin = fs / nfft
    startbin = max(int(round(lockingbw / hzperbin)), 1)
    epb = int(round(fb / (2.0 * hzperbin)))
    bins = jnp.arange(nfft)
    keep = (bins < startbin) | (bins > nfft - startbin)
    X = jnp.fft.fft(x, axis=-1) * keep.astype(jnp.complex64)
    sq = jnp.fft.ifft(X, axis=-1) ** 2
    S = jnp.abs(jnp.fft.fftshift(jnp.fft.fft(sq, axis=-1), axes=-1))
    db = 10.0 * jnp.log10(jnp.maximum(S, 1.0))
    tot = jnp.zeros_like(db)
    for j in (-1, 0, 1):
        tot = tot + jnp.roll(db, epb + j, -1) + jnp.roll(db, -(epb + j), -1)
    mid = nfft // 2
    span = int(round(lockingbw / hzperbin))
    inwin = (bins >= mid - span) & (bins < mid + span)
    loc = jnp.argmax(jnp.where(inwin, tot, -jnp.inf), axis=-1)
    return (loc - mid).astype(jnp.float32) * hzperbin * 0.5


@functools.partial(jax.jit, static_argnames=("cfg",))
def burst_msk_window(samples, gate, cfg: BurstMskConfig, freq_center=None):
    """Demodulate one burst window [window_len] with its sample gate.

    ``freq_center`` (traced scalar) overrides cfg.freq_center so a signal
    hunter can retune without recompiling (ref decode.cpp:182,211).
    Returns dict with soft [n_strobes, 2] float, strobe_active mask,
    freq estimate, tone quality.
    """
    if freq_center is None:
        freq_center = jnp.asarray(cfg.freq_center, jnp.float32)
    sps = cfg.sps
    W = cfg.window_len
    x = jnp.asarray(samples, jnp.float32)
    gate = jnp.asarray(gate, jnp.float32)

    # dilate the gate so edge bits at the smoothing ramps stay active
    dil = jnp.ones(8 * sps, jnp.float32)
    gate = (jnp.convolve(gate, dil, mode="same") > 0).astype(jnp.float32)

    phase0 = nco_init()
    _, bb = nco_mix(phase0, x.astype(jnp.complex64), freq_center / cfg.fs,
                    conj=True)
    dfc = _gated_coarse_offset(bb, gate, cfg.nfft, cfg.fb, cfg.fs,
                               cfg.lockingbw)
    n = jnp.arange(W, dtype=jnp.float32)
    bb = bb * jnp.exp(-2j * jnp.pi * (dfc / cfg.fs) * n).astype(jnp.complex64)

    taps = jnp.asarray(msk_matched_filter(sps), jnp.float32)
    _, y = fir_apply(fir_init(2 * sps, dtype=jnp.complex64), bb, taps)

    gsum = jnp.maximum(jnp.sum(gate), 1.0)
    gmean = jnp.sum(jnp.abs(y) * gate) / gsum
    y = y * (jnp.sqrt(2.0) / jnp.maximum(gmean, 1e-6))
    mag = jnp.abs(y)
    y = jnp.where(mag > 2.84, y * (2.84 / jnp.maximum(mag, 1e-9)), y)

    df, theta0, t0_bits, quality = _tone_pair_sync(
        y * gate.astype(y.dtype), cfg.fb / cfg.fs,
        cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)

    rot = jnp.exp(-1j * (theta0 + 2.0 * jnp.pi * df * n)).astype(jnp.complex64)
    yr = y * rot

    n_strobes = W // (2 * sps)
    m = jnp.arange(n_strobes, dtype=jnp.float32)

    def interp(sig, p):
        p = jnp.clip(p, 0.0, sig.shape[-1] - 2.0)
        i0 = jnp.floor(p).astype(jnp.int32)
        w = (p - i0).astype(jnp.float32)
        return sig[i0] * (1.0 - w) + sig[i0 + 1] * w

    def strobes(g):
        pos = g + m * (2.0 * sps)
        cur = interp(yr, jnp.clip(pos, 0, W - 2))
        dly = interp(yr, jnp.clip(pos - sps, 0, W - 2))
        gt = interp(gate, jnp.clip(pos, 0, W - 2))
        return cur, dly, gt

    g_raw = jnp.mod(t0_bits * sps, sps)
    cand = jnp.stack([g_raw, g_raw + sps])

    def eye_mse(g):
        pc, pd, gt = strobes(g)
        tda = (jnp.abs(pc.real * 0.75) - 1.0) * gt
        tdb = (jnp.abs(pd.imag * 0.75) - 1.0) * gt
        return jnp.sum(tda * tda + tdb * tdb) / jnp.maximum(jnp.sum(gt), 1.0)

    grid = jnp.where(eye_mse(cand[0]) <= eye_mse(cand[1]), cand[0], cand[1])
    pts_cur, pts_del, gt = strobes(grid)
    active = gt > 0.5

    def diffdecode(seq):
        prev = jnp.concatenate([jnp.full((1,), -1.0, seq.dtype), seq[:-1]])
        both_neg = (seq < 0) & (prev < 0)
        both_pos = (seq > 0) & (prev > 0)
        return jnp.where(both_neg, prev,
                         jnp.where(both_pos, -prev, jnp.abs(prev)))

    ob_im = diffdecode(pts_del.imag)
    ob_re = -diffdecode(pts_cur.real)
    soft = jnp.stack(
        [jnp.clip(jnp.round(ob_im * 127.0 + 128.0), 0, 255),
         jnp.clip(jnp.round(ob_re * 127.0 + 128.0), 0, 255)], axis=-1)

    return {
        "soft": soft,
        "active": active,
        "freq_offset": dfc + df * cfg.fs,
        "tone_quality": quality,
    }



from aero_tpu.models.burst_common import BurstWindowDemodulator


class BurstMskDemodulator(BurstWindowDemodulator):
    """Host wrapper: detection over blocks + per-burst window demod."""

    def __init__(self, fs: float, fb: float, **kw):
        super().__init__(make_config(fs, fb, **kw), burst_msk_window)
