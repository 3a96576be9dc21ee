"""Numerically-controlled oscillators as vectorized phase ramps.

The reference implements NCOs as per-sample wavetable walks
(``publish/oscillator.cpp:18-39``, ``decode/DSP.cpp:35-262`` WaveTable).
Here we generate the whole block's phasor ramp at once: ``exp(j*(phi0 + 2*pi*
f/Fs * n))`` over ``n = 0..T-1`` and carry only the end phase between blocks.

Phase is carried in *cycles* (not radians) and wrapped with ``mod 1`` so
float32 never accumulates magnitude; a VFO that runs for days keeps full
precision.
"""

from __future__ import annotations

import jax.numpy as jnp


def nco_init(phase_cycles=0.0, dtype=jnp.float32):
    """State = current phase in cycles, shape [] (or any leading batch)."""
    return jnp.asarray(phase_cycles, dtype=dtype)


def nco_phase_ramp(state, freq_norm, length: int):
    """Return (new_state, phase ramp in cycles, shape [..., length]).

    ``freq_norm`` = f/Fs in cycles/sample (scalar or batch matching state).
    """
    freq_norm = jnp.broadcast_to(jnp.asarray(freq_norm, state.dtype), jnp.shape(state))
    n = jnp.arange(length, dtype=state.dtype)
    ramp = state[..., None] + freq_norm[..., None] * n
    new_state = jnp.mod(state + freq_norm * length, 1.0)
    return new_state, jnp.mod(ramp, 1.0)


def nco_mix(state, x, freq_norm, conj: bool = False, extra_cycles=None):
    """Mix a block by ``exp(+/- 2 pi j * (phi0 + f n [+ extra]))``.

    x: [..., T] complex or real.  freq_norm: broadcastable to x[..., 0].
    ``extra_cycles`` [..., T] adds a per-sample phase term (in cycles)
    INSIDE the single exp — the demodulators' Doppler chirp derotation
    rides here instead of paying a second full-block complex exp and
    multiply.  The caller owns any state carry the extra term implies.
    Returns (new_state, mixed block).
    """
    freq_norm = jnp.asarray(freq_norm, dtype=state.dtype)
    new_state, ramp = nco_phase_ramp(state, freq_norm, x.shape[-1])
    if extra_cycles is not None:
        ramp = jnp.mod(ramp + extra_cycles, 1.0)
    ang = (2.0 * jnp.pi) * ramp
    osc = jnp.exp(1j * ang.astype(jnp.float32)).astype(jnp.complex64)
    if conj:
        osc = jnp.conj(osc)
    return new_state, x * osc
