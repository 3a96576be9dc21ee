"""Streaming block FIR filtering.

The reference filters one sample at a time through ring buffers
(``decode/DSP.cpp:266-355``, ``publish/halfbanddecimator.cpp:35-60``).  Here a
whole block is filtered with one dense convolution: the carry is just the last
``ntaps-1`` input samples (overlap-save), so results are bit-identical to an
infinite streaming filter regardless of block boundaries.

All ops take ``[..., T]`` blocks; leading axes are batch (VFO) axes and may be
vmapped/sharded.  Complex inputs with real taps are filtered as two real
convolutions.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def _corr_valid_real(x, h):
    """Valid-mode correlation of real x [..., L] with kernel h [K] -> [..., L-K+1]."""
    lead = x.shape[:-1]
    L = x.shape[-1]
    xb = x.reshape((-1, 1, L))
    hb = h.reshape((1, 1, -1)).astype(x.dtype)
    y = lax.conv_general_dilated(
        xb, hb, window_strides=(1,), padding="VALID",
        dimension_numbers=("NCH", "IOH", "NCH"))
    return y.reshape(lead + (y.shape[-1],))


def _corr_valid(x, h):
    if jnp.iscomplexobj(x):
        return (_corr_valid_real(x.real, h)
                + 1j * _corr_valid_real(x.imag, h)).astype(jnp.complex64)
    return _corr_valid_real(x, h)


def fir_init(ntaps: int, batch_shape=(), dtype=jnp.float32):
    """History carry: the last ntaps-1 inputs (zeros initially)."""
    return jnp.zeros(batch_shape + (ntaps - 1,), dtype=dtype)


def fir_apply(state, x, taps):
    """Causal FIR: y[n] = sum_k h[k] x[n-k].  Returns (new_state, y[..., T])."""
    taps = jnp.asarray(taps)
    k = taps.shape[0]
    xp = jnp.concatenate([state, x], axis=-1)
    y = _corr_valid(xp, taps[::-1])
    new_state = xp[..., -(k - 1):] if k > 1 else state
    return new_state, y


def fir_decimate_init(ntaps: int, batch_shape=(), dtype=jnp.float32):
    return jnp.zeros(batch_shape + (ntaps - 1,), dtype=dtype)


def fir_decimate_apply(state, x, taps, factor: int):
    """Causal FIR followed by keep-every-``factor``-th sample.

    Output sample m is the filter evaluated at input index m*factor.  Block
    length must be a multiple of ``factor`` so the phase carries cleanly.
    """
    taps = jnp.asarray(taps)
    k = taps.shape[0]
    if x.shape[-1] % factor:
        raise ValueError(f"block length {x.shape[-1]} not divisible by {factor}")
    xp = jnp.concatenate([state, x], axis=-1)
    lead = xp.shape[:-1]
    xb = xp.reshape((-1, 1, xp.shape[-1]))
    hb = taps[::-1].reshape((1, 1, -1))

    def conv(z):
        return lax.conv_general_dilated(
            z, hb.astype(z.dtype), window_strides=(factor,), padding="VALID",
            dimension_numbers=("NCH", "IOH", "NCH"))

    if jnp.iscomplexobj(xp):
        y = conv(xb.real) + 1j * conv(xb.imag)
        y = y.astype(jnp.complex64)
    else:
        y = conv(xb)
    y = y.reshape(lead + (y.shape[-1],))
    new_state = xp[..., -(k - 1):] if k > 1 else state
    return new_state, y


def fir_apply_fft(state, x, taps):
    """Causal FIR via FFT convolution (overlap-save) — for long kernels
    (e.g. the 2048-tap 8400 bps RRC prefilter, ref: oqpskdemodulator.cpp:
    239-249 JFastFir).  Same contract and results as fir_apply."""
    import jax.scipy.signal as jss

    taps = jnp.asarray(taps)
    k = taps.shape[0]
    xp = jnp.concatenate([state, x], axis=-1)
    if jnp.iscomplexobj(xp) and not jnp.iscomplexobj(taps):
        taps = taps.astype(xp.dtype)
    y = jss.fftconvolve(xp, taps, mode="valid")
    if jnp.iscomplexobj(xp):
        y = y.astype(jnp.complex64)
    else:
        y = y.astype(x.dtype)
    new_state = xp[..., -(k - 1):] if k > 1 else state
    return new_state, y


def delay_init(n: int, batch_shape=(), dtype=jnp.float32):
    """Integer delay line state (the reference's DelayThing,
    decode/DSP.h:446-486)."""
    return jnp.zeros(batch_shape + (n,), dtype=dtype)


def delay_apply(state, x):
    """Delay the block by ``state.shape[-1]`` samples."""
    n = state.shape[-1]
    xp = jnp.concatenate([state, x], axis=-1)
    return xp[..., -n:] if n else state, xp[..., : x.shape[-1]]


def halfband_cascade_init(n_stages: int, ntaps: int, batch_shape=(), dtype=jnp.complex64):
    return [fir_decimate_init(ntaps, batch_shape, dtype) for _ in range(n_stages)]


def halfband_cascade_apply(states, x, taps):
    """Run a 2:1 halfband decimator ``len(states)`` times (block len % 2^n == 0).

    Same spectral shape as the reference's cascade (publish/vfo.cpp:163-165);
    the per-stage taps come from ``design.HALFBAND_TAPS``.
    """
    new_states = []
    for st in states:
        st, x = fir_decimate_apply(st, x, taps, 2)
        new_states.append(st)
    return new_states, x
