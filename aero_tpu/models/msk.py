"""Continuous MSK demodulator (600/1200 bps Aero P channel) and modulator.

Block-vectorized redesign of the reference's per-sample loop
(ref: decode/mskdemodulator.cpp:252-428).  Where the reference runs three
per-sample feedback loops (timing PLL :323-340, carrier PLL :346-369, AGC),
this demodulator is FULLY FEEDFORWARD and dense — no lax.scan at all:

  1.  complex NCO mix to baseband (phase-continuous across blocks)
  2.  coarse CFO estimate (fold spectrum, models/coarse_freq) drives
      block-level retunes while unlocked
  3.  half-sine matched filter (streaming conv)
  4.  block AGC + clip at 2.84 (ref :315-318)
  5.  joint fine-CFO / carrier-phase / symbol-timing estimation from the
      squared signal: for MSK, E[exp(2j phi(t))] = cos(pi (t-t0)/T) exactly,
      so y^2 carries a deterministic tone pair at 2*df +- fb/2 with
      amplitudes a+- = 1/2 exp(2j theta0) exp(-+ j pi t0 / T).  Hence
          df     = (f+ + f-)/4           (shared-offset grid search)
          theta0 = arg(a+ a-)/4          (mod pi/2)
          t0     = -arg(a+ conj(a-)) T/(2 pi)   (mod T)
      The mod-pi/2 / mod-T ambiguities are exactly stream shifts after
      differential decoding, which the polarity-invariant UW deframer
      absorbs; cross-block continuity picks consistent candidates.
  6.  derotate the whole block, gather strobe samples on the timing grid,
      build pt = (Re y'[n], Im y'[n-sps]) (MSK->OQPSK trick, ref :320-321)
  7.  vectorized differential soft decode (ref DiffDecode semantics,
      DSP.cpp:523-548), real arm negated (ref :391-412), bytes 0..255

Everything is convolutions, FFTs, small matmuls (the tone-grid DFT) and
elementwise work — dense, vmappable over a VFO axis.

Block length must be a multiple of 2*sps (16000 works for every (Fs, fb)
pair the reference supports: sps in {10, 20, 40, 80}).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from aero_tpu.ops import (nco_init, nco_mix, fir_init, fir_apply,
                          msk_matched_filter, block_agc)
from aero_tpu.models.coarse_freq import coarse_freq_init, coarse_freq_estimate


class MskState(NamedTuple):
    nco_phase: jnp.ndarray      # mixer phase, cycles
    freq: jnp.ndarray           # current mix frequency, Hz
    slope: jnp.ndarray          # CFO drift estimate, Hz/s (Doppler ramp)
    coarse_y: jnp.ndarray       # smoothed fold spectrum [nfft]
    mf_state: jnp.ndarray       # matched filter history [2*sps-1] complex
    agc_ema: jnp.ndarray        # running mean |mf out|
    tail: jnp.ndarray           # last 2*sps filtered samples (strobe context)
    theta: jnp.ndarray          # carrier phase at block start, rad
    grid: jnp.ndarray           # strobe-grid phase, samples mod 2*sps
    grid_rate: jnp.ndarray      # grid drift, samples/block (RX clock ppm)
    have_lock_refs: jnp.ndarray # bool: theta/grid carries are meaningful
    diff_im: jnp.ndarray        # differential decoder memory, imag arm
    diff_re: jnp.ndarray        # differential decoder memory, real arm
    mse: jnp.ndarray            # constellation MSE EMA


class MskConfig(NamedTuple):
    fs: float
    fb: float
    sps: int
    block_len: int
    nfft: int
    lockingbw: float
    freq_center: float
    signal_threshold: float
    fine_span_hz: float
    fine_step_hz: float
    track_span_hz: float
    track_segments: int


def make_config(fs: float, fb: float, block_len: int = 16000,
                lockingbw: float = 900.0, freq_center: float = 1000.0,
                signal_threshold: float = 0.5, nfft: int = 8192,
                fine_span_hz: float | None = None,
                fine_step_hz: float = 0.25,
                track_span_hz: float = 200.0,
                track_segments: int = 8) -> MskConfig:
    sps = int(fs / fb)
    assert block_len % (2 * sps) == 0
    assert block_len >= nfft
    assert block_len % track_segments == 0
    if fine_span_hz is None:
        # must cover the worst-case residual after a coarse retune:
        # the fold estimate quantizes to half a coarse FFT bin, searched in
        # the nu = 2*df domain -> span 2*(fs/nfft/2) plus margin
        fine_span_hz = fs / nfft + 2.0
    return MskConfig(fs, fb, sps, block_len, nfft, lockingbw, freq_center,
                     signal_threshold, fine_span_hz, fine_step_hz,
                     track_span_hz, track_segments)


def msk_init(cfg: MskConfig) -> MskState:
    return MskState(
        nco_phase=nco_init(),
        freq=jnp.asarray(cfg.freq_center, jnp.float32),
        slope=jnp.asarray(0.0, jnp.float32),
        coarse_y=coarse_freq_init(cfg.nfft),
        mf_state=fir_init(2 * cfg.sps, dtype=jnp.complex64),
        agc_ema=jnp.asarray(0.0, jnp.float32),
        tail=jnp.zeros(4 * cfg.sps, jnp.complex64),
        theta=jnp.asarray(0.0, jnp.float32),
        grid=jnp.asarray(0.0, jnp.float32),
        grid_rate=jnp.asarray(0.0, jnp.float32),
        have_lock_refs=jnp.asarray(False),
        diff_im=jnp.asarray(-1.0, jnp.float32),
        diff_re=jnp.asarray(-1.0, jnp.float32),
        mse=jnp.asarray(2.0, jnp.float32),
    )


@functools.lru_cache(maxsize=None)
def _tone_grid(T: int, fb_norm: float, span_cyc: float, step_cyc: float):
    """Static candidate grid and its DFT matrix (numpy, cached)."""
    n = np.arange(T, dtype=np.float64)
    nu = np.arange(-span_cyc, span_cyc + step_cyc / 2, step_cyc,
                   dtype=np.float64)
    freqs = np.concatenate([nu + fb_norm / 2.0, nu - fb_norm / 2.0])
    tw = np.exp(-2j * np.pi * (freqs[:, None] * n[None, :] % 1.0))
    return nu.astype(np.float32), tw.astype(np.complex64)


def _tone_pair_sync(y, fb_norm, span_cyc, step_cyc):
    """Estimate (df_norm, theta0, t0_bits) from the squared signal.

    y: [..., T] complex (matched-filter output).  Returns df in
    cycles/sample, theta0 in rad (mod pi/2), t0 in bit periods (mod 1),
    and the tone power (lock quality).
    """
    T = y.shape[-1]
    s2 = y * y
    # candidate shared offsets nu = 2*df: a STATIC grid per config, so the
    # [2C, T] DFT matrix is precomputed in numpy at trace time (a 1.25M-
    # element device exp per step otherwise) and lands as a jit constant
    nu_np, tw_np = _tone_grid(T, float(fb_norm), float(span_cyc),
                              float(step_cyc))
    nu = jnp.asarray(nu_np)
    coeffs = jnp.einsum("ct,...t->...c", jnp.asarray(tw_np), s2)
    C = nu.shape[0]
    c_hi, c_lo = coeffs[..., :C], coeffs[..., C:]
    score = jnp.abs(c_hi) + jnp.abs(c_lo)
    best = jnp.argmax(score, axis=-1)
    a_p = jnp.take_along_axis(c_hi, best[..., None], axis=-1)[..., 0]
    a_m = jnp.take_along_axis(c_lo, best[..., None], axis=-1)[..., 0]
    nu_hat = nu[best]

    # refine nu by phase slope between block halves at the winning bins
    half = T // 2
    def dft_at(x, f):
        nn = jnp.arange(x.shape[-1], dtype=jnp.float32)
        twl = jnp.exp(-2j * jnp.pi * ((f[..., None] * nn) % 1.0)).astype(jnp.complex64)
        return jnp.sum(x * twl, axis=-1)
    f_ref = nu_hat + fb_norm / 2.0
    c1 = dft_at(s2[..., :half], f_ref)
    # dft over the second half uses local indices, so it carries an extra
    # exp(+2j pi f_ref half) relative to the global-index DFT — cancel it
    c2 = dft_at(s2[..., half:], f_ref) * jnp.exp(
        -2j * jnp.pi * ((f_ref * half) % 1.0)).astype(jnp.complex64)
    dnu = jnp.angle(c2 * jnp.conj(c1)) / (2.0 * jnp.pi * half)
    nu_hat = nu_hat + dnu
    a_p = dft_at(s2, nu_hat + fb_norm / 2.0)
    a_m = dft_at(s2, nu_hat - fb_norm / 2.0)

    df = nu_hat / 2.0
    theta0 = jnp.angle(a_p * a_m) / 4.0
    t0 = -jnp.angle(a_p * jnp.conj(a_m)) / (2.0 * jnp.pi)  # bit periods mod 1
    quality = (jnp.abs(a_p) + jnp.abs(a_m)) / (jnp.asarray(T, jnp.float32))
    return df, theta0, t0, quality


@functools.lru_cache(maxsize=None)
def _track_grid(T: int, fb_norm: float, span_cyc: float):
    """Wide, coarse tone grid for the per-segment CFO-slope tracker
    (numpy, cached; step = half a segment DFT bin)."""
    step = 0.5 / T
    n = np.arange(T, dtype=np.float64)
    nu = np.arange(-span_cyc, span_cyc + step / 2, step, dtype=np.float64)
    freqs = np.concatenate([nu + fb_norm / 2.0, nu - fb_norm / 2.0])
    tw = np.exp(-2j * np.pi * (freqs[:, None] * n[None, :] % 1.0))
    return nu.astype(np.float32), tw.astype(np.complex64)


def _segment_slope_track(y, fb_norm, span_cyc, S):
    """Residual CFO ramp measurement from the squared signal.

    The precision estimator (_tone_pair_sync) integrates the whole block,
    so a Doppler ramp smears its tones into uselessness (a 25 Hz/s ramp
    sweeps the squared-domain tone across ~11 DFT bins of a 0.67 s
    block).  Splitting the block into S short segments keeps each
    segment's tones sharp; a weighted linear fit of per-segment tone
    frequency vs time yields the residual CFO ramp and the wide-range
    residual average that drive the block-rate slope tracker.

    Returns (df_wide, slope_res, quality): residual average CFO at block
    center [cycles/sample], residual CFO slope [cycles/sample^2], and
    mean segment tone quality.
    """
    T = y.shape[-1] // S
    s2 = (y * y).reshape(y.shape[:-1] + (S, T))
    nu_np, tw_np = _track_grid(T, float(fb_norm), float(span_cyc))
    nu = jnp.asarray(nu_np)
    coeffs = jnp.einsum("ct,...st->...sc", jnp.asarray(tw_np), s2)
    C = nu.shape[0]
    score = jnp.abs(coeffs[..., :C]) + jnp.abs(coeffs[..., C:])   # [S, C]
    best = jnp.argmax(score, axis=-1)                             # [S]
    # sub-bin quadratic peak interpolation: the argmax alone quantizes
    # each segment's tone to half a DFT bin, and with the weaker
    # squared-signal tones of the 8400 alpha=0.6 pulse that jitter fed
    # the slope tracker +-12 Hz/s of noise per block — enough to ring a
    # limit cycle between the slope and the fine fold-in (measured:
    # freq flapping +-2.5 Hz block-over-block on a clean +10 Hz offset)
    step = nu[1] - nu[0]
    bl = jnp.clip(best - 1, 0, C - 1)
    br = jnp.clip(best + 1, 0, C - 1)
    s0 = jnp.take_along_axis(score, best[..., None], axis=-1)[..., 0]
    sl = jnp.take_along_axis(score, bl[..., None], axis=-1)[..., 0]
    sr = jnp.take_along_axis(score, br[..., None], axis=-1)[..., 0]
    denom = sl - 2.0 * s0 + sr
    frac = jnp.where(jnp.abs(denom) > 1e-9,
                     0.5 * (sl - sr) / denom, 0.0)
    nu_s = nu[best] + jnp.clip(frac, -0.5, 0.5) * step
    w = s0
    w = w / (jnp.sum(w, axis=-1, keepdims=True) + 1e-9)
    # weighted LS fit nu_s ~ a + b*(segment center sample index)
    x = (jnp.arange(S, dtype=jnp.float32) + 0.5) * T
    xm = jnp.sum(w * x, axis=-1, keepdims=True)
    ym = jnp.sum(w * nu_s, axis=-1, keepdims=True)
    sxx = jnp.sum(w * (x - xm) ** 2, axis=-1)
    sxy = jnp.sum(w * (x - xm) * (nu_s - ym), axis=-1)
    b = sxy / jnp.maximum(sxx, 1e-9)
    a_mid = ym[..., 0] + b * (S * T / 2.0 - xm[..., 0])
    # quality = weighted mean per-segment peak-to-average score ratio:
    # scale-free, so one threshold serves both MSK and OQPSK (whose
    # absolute squared-signal tone power differs with the pulse shape)
    peak = jnp.take_along_axis(score, best[..., None], axis=-1)[..., 0]
    par = peak / jnp.maximum(jnp.mean(score, axis=-1), 1e-9)
    quality = jnp.sum(w * par, axis=-1)
    # a REAL residual ramp lies on a tight line through the segments
    # (sub-bin scatter after peak interpolation); structured garbage —
    # e.g. spectral junk lighting random grid bins while the true tones
    # sit outside the span during acquisition — scatters widely.  Zero
    # the quality then, so the slope tracker and wide fold-in ignore
    # the measurement instead of being flung by it.
    fitted = ym + b[..., None] * (x - xm)
    resid = jnp.sqrt(jnp.sum(w * (nu_s - fitted) ** 2, axis=-1))
    quality = jnp.where(resid < 4.0 * (0.5 / T), quality, 0.0)
    return a_mid / 2.0, b / 2.0, quality


def _chirp_cycles(slope, fs, L):
    """Per-sample chirp phase (cycles) for the carried CFO slope, plus
    the end-of-block phase to fold into the NCO carry.

    0.5*s*n^2 is built by cumsum — n^2 overflows the float32 mantissa at
    n=16000 — and the float() guards matter because cfg.fs may arrive as
    a Python int whose square overflows the int32 JAX would parse."""
    slope_cps2 = slope / (float(fs) * float(fs))
    n_all = jnp.arange(L, dtype=jnp.float32)
    inc = slope_cps2 * (n_all + 0.5)
    chirp_cyc = jnp.cumsum(inc) - inc
    chirp_end = (0.5 * L) * (slope_cps2 * L)
    return chirp_cyc, chirp_end


def _doppler_fold(prev_slope, freq, retune, locked, df, df_wide, slope_res,
                  tq, fs, T_blk, fine_span_hz, clamp_hzps, slope_max):
    """Shared Doppler fold-in + slope tracker (block rate; MSK and OQPSK
    differ only in clamps).

    Folds the block-END residual, not the block average: df measures the
    average, which under a residual ramp e lags the end frequency by
    e*T/2 — folding the average alone hands a -e*T/2 error to the next
    block and rings a period-2 limit cycle with the slope tracker.  When
    the residual sits beyond the fine grid's reach (ramp acquisition,
    post-retune) the wide segment-tracker average folds in instead — a
    mini-retune that keeps the coarse loop out of the tracking business.
    Both the end correction and the slope update clamp the segment-fit
    slope: one interference-corrupted segment can fling the weighted LS
    fit hundreds of Hz/s.  The slope needs no lock to update (ramp
    acquisition happens while mse is still ~1); a leak bounds it when
    the tones vanish.

    Returns (freq, slope, wide_jump, tq_ok).
    """
    tq_ok = tq > 3.5
    df_wide_hz = df_wide * fs
    slope_res_hz = slope_res * (float(fs) * float(fs))
    wide_jump = (jnp.abs(df_wide_hz) > fine_span_hz) \
        & tq_ok & jnp.logical_not(retune)
    end_corr = jnp.where(
        tq_ok,
        0.5 * jnp.clip(slope_res_hz, -clamp_hzps, clamp_hzps) * T_blk, 0.0)
    freq = freq + prev_slope * T_blk \
        + jnp.where(retune, 0.0,
                    jnp.where(wide_jump, df_wide_hz, df * fs) + end_corr)
    slope = prev_slope + jnp.where(
        tq_ok, jnp.clip(0.7 * slope_res_hz, -clamp_hzps, clamp_hzps), 0.0)
    slope = jnp.where(tq_ok | locked, slope, 0.9 * slope)
    slope = jnp.clip(slope, -slope_max, slope_max)
    return freq, slope, wide_jump, tq_ok


def _timing_track(prev_grid, prev_rate, g_raw, unit, tracking, L,
                  grid_acq):
    """Shared second-order timing loop (alpha-beta on grid + drift rate).

    ``unit`` is the g_raw ambiguity period in samples (sps for MSK, one
    strobe interval for OQPSK); renormalization happens with the same
    2*unit wrap in both, and is reported as a slip (+1 = a bit pair was
    skipped, -1 = duplicated) for host realignment.

    Returns (grid, grid_rate, slip).
    """
    pred = prev_grid + prev_rate
    delta = jnp.mod(g_raw - pred + unit / 2.0, unit) - unit / 2.0
    grid_track = pred + 0.5 * delta
    rate_max = 300e-6 * L                    # +-300 ppm capture
    grid_rate = jnp.where(tracking, prev_rate + 0.25 * delta,
                          0.95 * prev_rate)
    grid_rate = jnp.clip(grid_rate, -rate_max, rate_max)
    grid = jnp.where(tracking, grid_track, grid_acq)
    slip = jnp.where(tracking & (grid < -0.5 * unit), jnp.int32(1),
                     jnp.where(tracking & (grid >= 2.5 * unit),
                               jnp.int32(-1), jnp.int32(0)))
    grid = jnp.where(grid < -0.5 * unit, grid + 2.0 * unit,
                     jnp.where(grid >= 2.5 * unit, grid - 2.0 * unit,
                               grid))
    return grid, grid_rate, slip


@functools.partial(jax.jit, static_argnames=("cfg",))
def msk_step(state: MskState, samples, cfg: MskConfig):
    """Process one block of real audio samples [block_len].

    Returns (new_state, outputs dict).  Soft bits: two per strobe
    [imag_bit, real_bit], bytes 0..255 (128 = neutral).
    """
    sps = cfg.sps
    L = cfg.block_len
    x = jnp.asarray(samples, jnp.float32)

    # 1. mix to baseband at the carried frequency, then chirp-derotate by
    #    the carried CFO slope (Doppler-ramp tracking).  The reference's
    #    per-sample carrier PLL follows a ramp for free
    #    (mskdemodulator.cpp:346-369); the block-feedforward design must
    #    instead model it: without this, a 25 Hz/s ramp leaves +-9 rad of
    #    quadratic phase across a 0.67 s block (measured: 0/56 frames).
    #    The slope estimate is an alpha-beta tracker at BLOCK rate — still
    #    no per-sample feedback anywhere.
    fnorm = state.freq / cfg.fs
    # the chirp rides INSIDE the mixer's exp (nco_mix extra_cycles) so
    # Doppler derotation costs adds, not a second complex exp+multiply;
    # continuity: the chirp adds 0.5*s*L^2 cycles by block end, and the
    # instantaneous mix frequency ends at freq + slope*T_blk
    chirp_cyc, chirp_end = _chirp_cycles(state.slope, cfg.fs, L)
    nco_phase, bb = nco_mix(state.nco_phase, x.astype(jnp.complex64), fnorm,
                            conj=True, extra_cycles=chirp_cyc)
    nco_phase = jnp.mod(nco_phase + chirp_end, 1.0)
    T_blk = L / float(cfg.fs)

    # 2. coarse CFO estimate (drives retunes while unlocked)
    coarse_y, dfc = coarse_freq_estimate(
        state.coarse_y, bb, nfft=cfg.nfft, fb=cfg.fb, fs=cfg.fs,
        lockingbw=cfg.lockingbw)

    # 3. matched filter
    taps = jnp.asarray(msk_matched_filter(sps), jnp.float32)
    mf_state, y = fir_apply(state.mf_state, bb, taps)

    # 4. AGC + clip
    agc_ema, gain = block_agc(state.agc_ema, jnp.abs(y))
    y = y * gain
    mag = jnp.abs(y)
    y = jnp.where(mag > 2.84, y * (2.84 / jnp.maximum(mag, 1e-9)), y)

    # 5. joint feedforward sync from the squared signal
    fb_norm = cfg.fb / cfg.fs
    df, theta0, t0_bits, quality = _tone_pair_sync(
        y, fb_norm, cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)
    # 5b. residual-ramp measurement (Doppler tracking): per-segment tones
    # over a wide grid, weighted-LS slope fit — feeds the block-rate
    # slope tracker and a wide-range fold-in the fine grid can't reach
    df_wide, slope_res, tq = _segment_slope_track(
        y, fb_norm, 2.0 * cfg.track_span_hz / cfg.fs, cfg.track_segments)

    def circdist(a, b, m):
        return jnp.abs(jnp.mod(a - b + m / 2, m) - m / 2)

    # carrier phase: candidates theta0 + k pi/2, continuity with carry
    k = jnp.arange(4, dtype=jnp.float32)
    cand_th = theta0 + k * (jnp.pi / 2.0)
    dth = circdist(cand_th, state.theta, 2.0 * jnp.pi)
    th_cont = cand_th[jnp.argmin(dth)]
    theta = jnp.where(state.have_lock_refs, th_cont, theta0)

    # 6. derotate the whole block
    TAIL = 4 * sps
    n = jnp.arange(L, dtype=jnp.float32)
    rot = jnp.exp(-1j * (theta + 2.0 * jnp.pi * df * n)).astype(jnp.complex64)
    yr = y * rot
    # context: the tail is stored raw; derotate it in this block's reference
    tail_rot = jnp.exp(-1j * (theta + 2.0 * jnp.pi * df *
                              jnp.arange(-TAIL, 0, dtype=jnp.float32))).astype(jnp.complex64)
    ctx = jnp.concatenate([state.tail * tail_rot, yr])   # ctx[j] = yr[j-TAIL]
    tail = y[-TAIL:]                                     # store raw

    n_strobes = L // (2 * sps)
    m = jnp.arange(n_strobes, dtype=jnp.float32)

    def interp(sig, p):
        p = jnp.clip(p, 0.0, sig.shape[-1] - 2.0)
        i0 = jnp.floor(p).astype(jnp.int32)
        w = (p - i0).astype(jnp.float32)
        return sig[i0] * (1.0 - w) + sig[i0 + 1] * w

    def strobes(g):
        # strobe spacing scaled by the tracked RX/TX sample-clock ratio
        # (grid_rate samples of drift per block): under a +-100 ppm
        # clock offset the within-block timing error otherwise reaches
        # a large fraction of a strobe interval at the block edges.
        # The window sits ONE pair-interval in the past (m-1): with the
        # grid near the top of its legal range the last position would
        # otherwise run past the interpolation context (which holds only
        # past samples) and clamp — a systematically corrupted final bit
        # pair per block.  A uniform one-pair delay is invisible to the
        # shift-invariant UW deframers.
        pos = g + (m - 1.0) * (2.0 * sps) * (1.0 + state.grid_rate / L)
        return interp(ctx, pos + TAIL), interp(ctx, pos + TAIL - sps)

    # timing grid: t0 gives the grid mod sps; the arm parity (mod 2*sps) is
    # chosen by eye quality at acquisition.  The grid is carried as a
    # CONTINUOUS position (not re-wrapped per block): jitter in the estimate
    # can flip its [0, 2*sps) representative, and re-wrapping would slip the
    # bit stream by a whole strobe, so both the acquisition pick and the
    # tracking update are mapped to the representative nearest the carry.
    # Renormalization (a real bit-pair slip, only under sustained clock
    # drift) happens with +-sps/2 hysteresis.
    g_raw = jnp.mod(t0_bits * sps, sps)
    cand = jnp.stack([g_raw, g_raw + sps])

    def eye_mse(g):
        pc, pd = strobes(g)
        tda = jnp.abs(pc.real * 0.75) - 1.0
        tdb = jnp.abs(pd.imag * 0.75) - 1.0
        return jnp.mean(tda * tda + tdb * tdb)

    grid_acq = jnp.where(eye_mse(cand[0]) <= eye_mse(cand[1]),
                         cand[0], cand[1])
    grid_acq = grid_acq - jnp.round((grid_acq - state.grid) / (2.0 * sps)) * (2.0 * sps)

    # second-order timing: predict the grid forward by the tracked drift
    # rate, then correct half the innovation.  A first-order loop lags a
    # constant clock offset by 2x the per-block drift (3.2 samples at
    # 100 ppm) — the alpha-beta form tracks it to zero lag, exactly like
    # the reference's continuously-slewing per-sample timing NCO
    # (mskdemodulator.cpp:323-340) but at block rate.  Renormalizations
    # are real bit-pair slips, reported for host realignment
    # (protocol/framing.apply_slip).
    tracking = state.have_lock_refs & (state.mse < cfg.signal_threshold)
    grid, grid_rate, slip = _timing_track(
        state.grid, state.grid_rate, g_raw, float(sps), tracking, L,
        grid_acq)

    pts_cur, pts_del = strobes(grid)
    pt_re = pts_cur.real
    pt_im = pts_del.imag

    # 7. vectorized differential soft decode (both arms), real arm negated
    def diffdecode(seq, carry):
        prev = jnp.concatenate([carry[None], seq[:-1]])
        both_neg = (seq < 0) & (prev < 0)
        both_pos = (seq > 0) & (prev > 0)
        out = jnp.where(both_neg, prev, jnp.where(both_pos, -prev, jnp.abs(prev)))
        return out, seq[-1]

    # constellation strobe points, the reference's ScatterPoints GUI
    # signal (mskdemodulator.h:122-135, emitted-but-unconnected there;
    # unused consumers are dead-code-eliminated by XLA in fused paths)
    scatter = jnp.stack([pt_re, pt_im], axis=-1)

    ob_im, diff_im = diffdecode(pt_im, state.diff_im)
    ob_re, diff_re = diffdecode(pt_re, state.diff_re)
    ob_re = -ob_re
    soft = jnp.stack([jnp.clip(jnp.round(ob_im * 127.0 + 128.0), 0, 255),
                      jnp.clip(jnp.round(ob_re * 127.0 + 128.0), 0, 255)],
                     axis=-1).reshape(-1).astype(jnp.uint8)

    # constellation MSE (ref :386-388) as a block mean + EMA carry; right
    # after a retune the EMA restarts from the fresh block (the stale
    # carry only slows re-lock — a noise block still reads ~1.0, far from
    # threshold, so acquisition certainty is unchanged)
    tda = jnp.abs(pt_re * 0.75) - 1.0
    tdb = jnp.abs(pt_im * 0.75) - 1.0
    blk_mse = jnp.mean(tda * tda + tdb * tdb)
    mse = jnp.where(state.have_lock_refs,
                    0.7 * state.mse + 0.3 * blk_mse, blk_mse)
    locked = mse < cfg.signal_threshold

    # Eb/N0 estimate from the matched-filter envelope (scale-invariant;
    # ref MSKEbNoMeasure/OQPSKEbNoMeasure, DSP.cpp:482-508/691-727)
    from aero_tpu.ops.stats import msk_ebno
    _m = jnp.mean(mag)
    _v = jnp.mean(mag * mag) - _m * _m
    ebno_db = msk_ebno(_m, _v)

    # AFC: while unlocked, retune by the coarse estimate (relative to the
    # current mix freq; hysteresis avoids FFT-bin flapping).  Flood the
    # smoothed spectrum on retune (ref bigchange()).  A moderate stable
    # offset can hold a FALSE lock (the constant-envelope eye MSE degrades
    # gently with CFO), and an offset beyond the fine-CFO capture span can
    # never be absorbed by the fine loop — so retune then even if "locked".
    retune_threshold = 1.6 * (cfg.fs / cfg.nfft)
    stuck = jnp.abs(dfc) > 4.0 * cfg.fine_span_hz
    retune = (jnp.abs(dfc) > retune_threshold) \
        & (jnp.logical_not(locked) | stuck)
    freq = jnp.where(retune, state.freq + dfc, state.freq)
    coarse_y = jnp.where(retune, jnp.full_like(coarse_y, 20.0), coarse_y)

    # fine-CFO fold-in: absorb df into the mixer so the next block's tones
    # sit near 0 (phases stay continuous: adjust theta carry accordingly).
    # The mixer's instantaneous frequency ended at freq + slope*T_blk —
    # carry that as the new base so a tracked ramp needs no fold-in at
    # all.  When the residual sits beyond the fine grid's reach (ramp
    # acquisition, post-retune) fold in the wide segment-tracker average
    # instead — a mini-retune that keeps the coarse loop out of the
    # tracking business (its retunes reset phase/grid continuity, which
    # is what used to shred frames under a ramp).
    # both wide fold-in and slope update trust the segment tracker only
    # when it actually sees tones: the peak-to-average quality reads
    # 6.4-8.1 with tones present (both modems, down to 6 dB SNR) and
    # ~2.1 on pure noise (where the argmax fits would otherwise
    # random-walk the slope tens of Hz/s and fling spurious wide jumps)
    freq, slope, wide_jump, tq_ok = _doppler_fold(
        state.slope, freq, retune, locked, df, df_wide, slope_res, tq,
        cfg.fs, T_blk, cfg.fine_span_hz, clamp_hzps=80.0, slope_max=400.0)
    theta_next = jnp.mod(theta + 2.0 * jnp.pi * df * L, 2.0 * jnp.pi)
    have_refs = jnp.logical_not(retune | wide_jump)
    # the signal level at the new tune is unrelated to the old one: restart
    # the AGC carry so the next block normalizes from its own mean (the
    # reference's AGC window carries no long memory, DSP.cpp:358-385)
    agc_ema = jnp.where(retune, 0.0, agc_ema)

    new_state = MskState(nco_phase, freq, slope, coarse_y, mf_state, agc_ema,
                         tail, theta_next, grid, grid_rate, have_refs,
                         diff_im, diff_re, mse)
    out = {
        "soft_bits": soft,
        "mse": mse,
        "freq": freq,
        "slope": slope,
        "coarse_offset": dfc,
        "fine_offset": df * cfg.fs,
        "wide_offset": df_wide * cfg.fs,
        "track_quality": tq,
        "tone_quality": quality,
        "signal": locked,
        "ebno": ebno_db,
        "theta": theta,
        "grid": grid,
        "clock_ppm": grid_rate / L * 1e6,
        "slip": slip,
        "scatter": scatter,
    }
    return new_state, out


class MskDemodulator:
    """Host wrapper: one VFO, streaming over blocks."""

    def __init__(self, fs: float, fb: float, **kw):
        self.cfg = make_config(fs, fb, **kw)
        self.state = msk_init(self.cfg)

    def process(self, samples: np.ndarray):
        outs = []
        L = self.cfg.block_len
        n = (len(samples) // L) * L
        for i in range(0, n, L):
            self.state, out = msk_step(self.state, samples[i:i + L], self.cfg)
            outs.append({k: np.asarray(v) for k, v in out.items()})
        return outs

    def spectrum(self, nbins: int = 256):
        """Smoothed fold-spectrum snapshot: (freqs_hz, dB) — the
        reference's Plottables GUI feed (SURVEY.md §5)."""
        from aero_tpu.models.coarse_freq import spectrum_display
        return spectrum_display(self.state.coarse_y, self.cfg.fs, nbins)



# ---------------------------------------------------------------------------
# Modulator (for synthetic test vectors; the reference has no modulator)
# ---------------------------------------------------------------------------

def msk_modulate(bits, fs: float, fb: float, freq: float = 1000.0,
                 amplitude: float = 0.25, phase0: float = 0.0) -> np.ndarray:
    """MSK-modulate a bit stream to real audio at ``fs``.

    CPM form: carrier phase ramps +-pi/2 per bit period.  The precoder
    inverts the demodulator's per-arm differential decode with its
    alternating-arm inversion (real arm negated), so the demodulated stream
    reproduces ``bits`` up to a bounded shift + polarity that the UW
    deframer absorbs.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    sps = int(fs / fb)
    e = np.empty_like(bits)
    prev = 0
    for k in range(len(bits)):
        cur = bits[k] ^ prev if (k % 2 == 0) else bits[k] ^ prev ^ 1
        e[k] = cur
        prev = cur
    d = 1.0 - 2.0 * e.astype(np.float64)
    phase_steps = np.repeat(d * (np.pi / 2.0) / sps, sps)
    phase = phase0 + np.concatenate([[0.0], np.cumsum(phase_steps)])[:-1]
    t = np.arange(len(phase))
    sig = amplitude * np.cos(2 * np.pi * freq / fs * t + phase)
    return sig.astype(np.float32)
