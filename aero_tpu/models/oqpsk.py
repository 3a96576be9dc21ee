"""Continuous OQPSK demodulator (10500 bps C-band P channel; 8400 bps
C-channel base) and modulator.

Block-vectorized redesign of the reference's per-sample loop
(ref: decode/oqpskdemodulator.cpp:284-560).  Same fully-feedforward
architecture as models/msk.py:

  - RRC matched filter alpha=1.0 (0.6 @8400), 55 taps at symbol rate fb/2
    (ref :173-183)
  - joint fine-CFO / carrier phase / timing from the squared-signal tone
    pair at 2*df +- fb/2: for OQPSK E[x^2] = exp(j(2 theta + 4 pi df t)) *
    (G(t) - G(t - Ts/2)) with G the symbol-rate pulse-energy train, so the
    same estimator as MSK applies (models/msk._tone_pair_sync)
  - strobes at rate fb (two per symbol, alternating arms; the reference's
    st_osc runs at fb, :231): Q-arm imag at even strobes, I-arm real at odd
    strobes, combined pt_qpsk = (I, Q_prev) (ref yui alternation :437-445)
  - straight soft mapping 0.75*pt*127+128, imag bit first (ref :513-530);
    NO differential decoding — polarity/arm ambiguities are handled by the
    deframer's phase-invariant UW detectors (protocol/framing)

Strobe spacing fs/fb is FRACTIONAL at 10500 (48000/10500 = 32/7); all
gathers interpolate, and block_len*fb/fs must be an even integer
(block_len=16000 at 48 kHz gives 3500 strobes).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from aero_tpu.ops import (nco_init, nco_mix, fir_init, fir_apply,
                          root_raised_cosine, block_agc)
from aero_tpu.ops.fir import fir_apply_fft
from aero_tpu.models.coarse_freq import coarse_freq_init, coarse_freq_estimate
from aero_tpu.models.msk import (_chirp_cycles, _doppler_fold,
                                 _segment_slope_track,
                                 _timing_track, _tone_pair_sync)


class OqpskState(NamedTuple):
    nco_phase: jnp.ndarray
    freq: jnp.ndarray
    slope: jnp.ndarray          # CFO drift estimate, Hz/s (Doppler ramp)
    coarse_y: jnp.ndarray
    mf_state: jnp.ndarray
    agc_ema: jnp.ndarray
    tail: jnp.ndarray           # last tail_len filtered samples (raw)
    theta: jnp.ndarray
    grid: jnp.ndarray           # position of first (Q) strobe, samples
    grid_rate: jnp.ndarray      # grid drift, samples/block (RX clock ppm)
    have_lock_refs: jnp.ndarray
    mse: jnp.ndarray


class OqpskConfig(NamedTuple):
    fs: float
    fb: float
    block_len: int
    nfft: int
    lockingbw: float
    freq_center: float
    signal_threshold: float
    fine_span_hz: float
    fine_step_hz: float
    alpha: float
    ntaps: int
    tail_len: int
    track_span_hz: float
    track_segments: int

    @property
    def strobe_step(self) -> float:
        return self.fs / self.fb          # samples per strobe (may be fractional)

    @property
    def n_strobes(self) -> int:
        return int(round(self.block_len * self.fb / self.fs))


def make_config(fs: float, fb: float, block_len: int = 16000,
                lockingbw: float = 10500.0, freq_center: float = 8000.0,
                signal_threshold: float = 0.65, nfft: int = 8192,
                fine_span_hz: float | None = None,
                fine_step_hz: float = 0.25,
                track_span_hz: float = 240.0,
                track_segments: int = 8) -> OqpskConfig:
    n_strobes = block_len * fb / fs
    assert abs(n_strobes - round(n_strobes)) < 1e-9 and round(n_strobes) % 2 == 0
    assert block_len >= nfft
    assert block_len % track_segments == 0
    if fine_span_hz is None:
        fine_span_hz = fs / nfft + 2.0
    alpha = 0.6 if fb == 8400 else 1.0
    step = fs / fb
    tail_len = int(np.ceil(4 * step)) + 2
    # at 8400 the reference replaces the 55-tap MF with a 2048-tap RRC
    # fast-convolution prefilter for adjacent-channel rejection
    # (ref: oqpskdemodulator.cpp:239-249, 376-386)
    ntaps = 2049 if fb == 8400 else 55
    # C-band Doppler rates run ~2.4x L-band (3.6/1.5 GHz), so the slope
    # tracker's wide grid spans more than the MSK default
    return OqpskConfig(fs, fb, block_len, nfft, lockingbw, freq_center,
                       signal_threshold, fine_span_hz, fine_step_hz, alpha,
                       ntaps, tail_len, track_span_hz, track_segments)


def oqpsk_init(cfg: OqpskConfig) -> OqpskState:
    return OqpskState(
        nco_phase=nco_init(),
        freq=jnp.asarray(cfg.freq_center, jnp.float32),
        slope=jnp.asarray(0.0, jnp.float32),
        coarse_y=coarse_freq_init(cfg.nfft),
        mf_state=fir_init(cfg.ntaps, dtype=jnp.complex64),
        agc_ema=jnp.asarray(0.0, jnp.float32),
        tail=jnp.zeros(cfg.tail_len, jnp.complex64),
        theta=jnp.asarray(0.0, jnp.float32),
        grid=jnp.asarray(0.0, jnp.float32),
        grid_rate=jnp.asarray(0.0, jnp.float32),
        have_lock_refs=jnp.asarray(False),
        mse=jnp.asarray(2.0, jnp.float32),
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def oqpsk_step(state: OqpskState, samples, cfg: OqpskConfig):
    L = cfg.block_len
    step = cfg.strobe_step                 # Ts/2 in samples
    x = jnp.asarray(samples, jnp.float32)

    fnorm = state.freq / cfg.fs
    # chirp-derotate by the carried CFO slope (Doppler-ramp tracking,
    # shared with MSK; the chirp rides inside the mixer's exp)
    chirp_cyc, chirp_end = _chirp_cycles(state.slope, cfg.fs, L)
    nco_phase, bb = nco_mix(state.nco_phase, x.astype(jnp.complex64), fnorm,
                            conj=True, extra_cycles=chirp_cyc)
    nco_phase = jnp.mod(nco_phase + chirp_end, 1.0)
    T_blk = L / float(cfg.fs)

    coarse_y, dfc = coarse_freq_estimate(
        state.coarse_y, bb, nfft=cfg.nfft, fb=cfg.fb, fs=cfg.fs,
        lockingbw=cfg.lockingbw)

    taps = jnp.asarray(root_raised_cosine(cfg.alpha, cfg.ntaps, cfg.fs,
                                          cfg.fb / 2.0), jnp.float32)
    if cfg.ntaps > 256:
        mf_state, y = fir_apply_fft(state.mf_state, bb, taps)
    else:
        mf_state, y = fir_apply(state.mf_state, bb, taps)

    agc_ema, gain = block_agc(state.agc_ema, jnp.abs(y))
    y = y * gain
    mag = jnp.abs(y)
    y = jnp.where(mag > 2.84, y * (2.84 / jnp.maximum(mag, 1e-9)), y)

    fb_norm = cfg.fb / cfg.fs
    df, theta0, t0_sym, quality = _tone_pair_sync(
        y, fb_norm, cfg.fine_span_hz / cfg.fs, cfg.fine_step_hz / cfg.fs)
    df_wide, slope_res, tq = _segment_slope_track(
        y, fb_norm, 2.0 * cfg.track_span_hz / cfg.fs, cfg.track_segments)

    def circdist(a, b, m):
        return jnp.abs(jnp.mod(a - b + m / 2, m) - m / 2)

    k4 = jnp.arange(4, dtype=jnp.float32)
    cand_th = theta0 + k4 * (jnp.pi / 2.0)
    dth = circdist(cand_th, state.theta, 2.0 * jnp.pi)
    th_cont = cand_th[jnp.argmin(dth)]
    theta = jnp.where(state.have_lock_refs, th_cont, theta0)

    TAIL = cfg.tail_len
    n = jnp.arange(L, dtype=jnp.float32)
    rot = jnp.exp(-1j * (theta + 2.0 * jnp.pi * df * n)).astype(jnp.complex64)
    yr = y * rot
    tail_rot = jnp.exp(-1j * (theta + 2.0 * jnp.pi * df *
                              jnp.arange(-TAIL, 0, dtype=jnp.float32))).astype(jnp.complex64)
    ctx = jnp.concatenate([state.tail * tail_rot, yr])
    tail = y[-TAIL:]

    n_pairs = cfg.n_strobes // 2
    m = jnp.arange(n_pairs, dtype=jnp.float32)

    def interp(sig, p):
        p = jnp.clip(p, 0.0, sig.shape[-1] - 2.0)
        i0 = jnp.floor(p).astype(jnp.int32)
        w = (p - i0).astype(jnp.float32)
        return sig[i0] * (1.0 - w) + sig[i0 + 1] * w

    def pair_points(g):
        """Q strobes at g + (m-2)*2*step, I strobes half a symbol later —
        spacing scaled by the tracked RX/TX clock ratio, window two
        pair-intervals in the past so the final I strobe never runs off
        the interpolation context (see models/msk.py strobes; the step
        here is only 4.57 samples at 10500, so without the shift most
        grid positions clamped the last strobe)."""
        scale = 1.0 + state.grid_rate / L
        pos_q = g + (m - 2.0) * (2.0 * step) * scale
        pos_i = pos_q + step * scale
        q = interp(ctx, pos_q + TAIL).imag
        i = interp(ctx, pos_i + TAIL).real
        return i, q

    # timing: the squared-signal tone pair sits at 2df +- fb/2, so the
    # phase difference measures t0 modulo the tone-BEAT period 1/fb = one
    # strobe interval (t0_sym is in units of that period).  The remaining
    # mod-Ts ambiguity is the arm pairing: two candidates a symbol-half
    # apart, picked by eye quality at acquisition, carried continuously
    # after.  (Scaling by Ts instead doubled the measured drift rate
    # under a sample-clock offset — the timing loop then chased phantom
    # 2x motion and slipped twice as often as the physics requires.)
    g_raw = jnp.mod(t0_sym * step, step)
    cand = jnp.stack([g_raw, g_raw + step])

    def eye_mse(g):
        """Self-normalized constellation MSE (ref MSEcalc, DSP.cpp:435-461:
        points scaled by sqrt(2)/mean|pt| before comparing to +-1)."""
        i, q = pair_points(g)
        mean_mag = jnp.maximum(jnp.mean(jnp.sqrt(i * i + q * q)), 1e-6)
        s = jnp.sqrt(2.0) / mean_mag
        tda = jnp.abs(i * s) - 1.0
        tdb = jnp.abs(q * s) - 1.0
        return jnp.mean(tda * tda + tdb * tdb)

    grid_acq = jnp.where(eye_mse(cand[0]) <= eye_mse(cand[1]),
                         cand[0], cand[1])
    grid_acq = grid_acq - jnp.round((grid_acq - state.grid) / (2.0 * step)) * (2.0 * step)

    # second-order timing (shared alpha-beta loop, models/msk.py): at
    # 10500 bps the strobe interval is only 4.57 samples, so the old
    # first-order loop's 2x-per-block-drift lag was most of an interval
    # under a 100 ppm clock offset; renormalizations are reported as
    # slips for host realignment
    tracking = state.have_lock_refs & (state.mse < cfg.signal_threshold)
    grid, grid_rate, slip = _timing_track(
        state.grid, state.grid_rate, g_raw, step, tracking, L, grid_acq)

    pt_i, pt_q = pair_points(grid)

    # soft bits: imag (Q) first then real (I) (ref :513-530)
    soft = jnp.stack(
        [jnp.clip(jnp.round(0.75 * pt_q * 127.0 + 128.0), 0, 255),
         jnp.clip(jnp.round(0.75 * pt_i * 127.0 + 128.0), 0, 255)],
        axis=-1).reshape(-1).astype(jnp.uint8)

    # EMA restarts from the fresh block after a retune (see models/msk.py)
    blk_mse = eye_mse(grid)
    mse = jnp.where(state.have_lock_refs,
                    0.7 * state.mse + 0.3 * blk_mse, blk_mse)
    locked = mse < cfg.signal_threshold

    # Eb/N0 estimate from the matched-filter envelope (scale-invariant;
    # ref MSKEbNoMeasure/OQPSKEbNoMeasure, DSP.cpp:482-508/691-727)
    from aero_tpu.ops.stats import msk_ebno
    _m = jnp.mean(mag)
    _v = jnp.mean(mag * mag) - _m * _m
    ebno_db = msk_ebno(_m, _v)

    # retune while unlocked, or when a stable coarse offset sits beyond
    # the fine-CFO capture span (false lock — see models/msk.py)
    retune_threshold = 1.6 * (cfg.fs / cfg.nfft)
    stuck = jnp.abs(dfc) > 4.0 * cfg.fine_span_hz
    retune = (jnp.abs(dfc) > retune_threshold) \
        & (jnp.logical_not(locked) | stuck)
    freq = jnp.where(retune, state.freq + dfc, state.freq)
    coarse_y = jnp.where(retune, jnp.full_like(coarse_y, 20.0), coarse_y)
    # Doppler-ramp fold-in + slope tracker, shared with MSK (the C-band
    # clamps are 2x the L-band ones — 2.4x the Doppler rates)
    freq, slope, wide_jump, tq_ok = _doppler_fold(
        state.slope, freq, retune, locked, df, df_wide, slope_res, tq,
        cfg.fs, T_blk, cfg.fine_span_hz, clamp_hzps=160.0, slope_max=800.0)
    theta_next = jnp.mod(theta + 2.0 * jnp.pi * df * L, 2.0 * jnp.pi)
    have_refs = jnp.logical_not(retune | wide_jump)
    # restart the AGC carry at the new tune (see models/msk.py)
    agc_ema = jnp.where(retune, 0.0, agc_ema)

    new_state = OqpskState(nco_phase, freq, slope, coarse_y, mf_state,
                           agc_ema, tail, theta_next, grid, grid_rate,
                           have_refs, mse)
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
        "grid": grid,
        "clock_ppm": grid_rate / L * 1e6,
        "slip": slip,
        # ScatterPoints analogue (see models/msk.py)
        "scatter": jnp.stack([pt_i, pt_q], axis=-1),
    }
    return new_state, out


class OqpskDemodulator:
    """Host wrapper: one VFO, streaming over blocks."""

    def __init__(self, fs: float, fb: float, **kw):
        self.cfg = make_config(fs, fb, **kw)
        self.state = oqpsk_init(self.cfg)

    def process(self, samples: np.ndarray):
        outs = []
        L = self.cfg.block_len
        n = (len(samples) // L) * L
        for i in range(0, n, L):
            self.state, out = oqpsk_step(self.state, samples[i:i + L], self.cfg)
            outs.append({k: np.asarray(v) for k, v in out.items()})
        return outs

    def spectrum(self, nbins: int = 256):
        """Smoothed fold-spectrum snapshot: (freqs_hz, dB) — the
        reference's Plottables GUI feed (SURVEY.md §5)."""
        from aero_tpu.models.coarse_freq import spectrum_display
        return spectrum_display(self.state.coarse_y, self.cfg.fs, nbins)



# ---------------------------------------------------------------------------
# Modulator (for synthetic test vectors)
# ---------------------------------------------------------------------------

def oqpsk_modulate(bits, fs: float, fb: float, freq: float = 8000.0,
                   amplitude: float = 0.25, alpha: float | None = None) -> np.ndarray:
    """OQPSK-modulate a bit stream to real audio at ``fs``.

    Stream layout matches the demodulator: bit 2m -> Q symbol m (imag arm),
    bit 2m+1 -> I symbol m (real arm, half a symbol later).  Synthesis runs
    on an oversampled integer grid (16 samples/bit) and is polyphase-
    resampled to ``fs``.
    """
    from scipy.signal import resample_poly
    from fractions import Fraction

    bits = np.asarray(bits, dtype=np.uint8)
    if len(bits) % 2:
        bits = np.append(bits, 0)
    if alpha is None:
        alpha = 0.6 if fb == 8400 else 1.0
    q = 1.0 - 2.0 * (bits[0::2] < 1)      # bit 1 -> +1
    i = 1.0 - 2.0 * (bits[1::2] < 1)

    os_per_bit = 16
    fs_hi = fb * os_per_bit
    sym_step = 2 * os_per_bit             # samples per symbol on the hi grid
    n_hi = len(q) * sym_step + 8 * sym_step
    qi_train = np.zeros(n_hi)
    ii_train = np.zeros(n_hi)
    off = 2 * sym_step
    qi_train[off + np.arange(len(q)) * sym_step] = q
    ii_train[off + os_per_bit + np.arange(len(i)) * sym_step] = i

    g = root_raised_cosine(alpha, 8 * sym_step + 1, fs_hi, fb / 2.0)
    xi = np.convolve(ii_train, g, mode="same")
    xq = np.convolve(qi_train, g, mode="same")
    x_hi = xi + 1j * xq

    frac = Fraction(int(fs), int(fs_hi)).limit_denominator(10000)
    x = resample_poly(x_hi, frac.numerator, frac.denominator)
    n = np.arange(len(x))
    s = amplitude * (x * np.exp(2j * np.pi * freq / fs * n)).real
    s /= max(1e-9, np.max(np.abs(s))) / amplitude
    return s.astype(np.float32)
