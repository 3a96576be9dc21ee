"""Block statistics: AGC, moving averages, Eb/N0 estimation.

The reference runs O(Fs)-long per-sample moving averages (decode/DSP.cpp:
358-385 AGC, 482-508 MSKEbNoMeasure).  The block formulation computes exact
windowed means with cumulative sums inside the block and an EMA carry across
blocks — same control behavior at block granularity, no sequential loops.
"""

from __future__ import annotations

import jax.numpy as jnp


def block_agc(ema_state, x_abs, alpha=0.1):
    """Return (new_ema, gain) for a block.

    gain = sqrt(2) / mean(|x|) with an exponential carry across blocks
    (ref AGC semantics: decode/DSP.cpp:358-385 — sqrt(2)/windowed mean |x|).
    ``ema_state`` holds the running mean |x|; shape = batch of the leading axes.
    """
    m = jnp.mean(x_abs, axis=-1)
    init = ema_state <= 0.0
    new_ema = jnp.where(init, m, (1.0 - alpha) * ema_state + alpha * m)
    gain = jnp.sqrt(2.0) / jnp.maximum(new_ema, 1e-6)
    return new_ema, jnp.maximum(gain, 1e-6)


def moving_average_init(batch_shape=(), dtype=jnp.float32):
    return jnp.zeros(batch_shape, dtype=dtype)


def moving_average_apply(state, x, alpha):
    """EMA over the trailing axis, returning per-sample smoothed values.

    Equivalent role to MovingAverage (decode/DSP.cpp:392-430) at block level:
    y[n] = (1-alpha) y[n-1] + alpha x[n], carried across blocks.
    Implemented as an associative scan (log depth).
    """
    import jax

    a = jnp.asarray(alpha, x.dtype)

    def combine(c1, c2):
        # each carry is (decay, value): y = decay*y_prev + value
        d1, v1 = c1
        d2, v2 = c2
        return d1 * d2, v2 + d2 * v1

    decays = jnp.full_like(x, 1.0 - a)
    vals = a * x
    # fold in the carried state as the "previous" value of the first element
    vals = vals.at[..., 0].add((1.0 - a) * state)
    _, y = jax.lax.associative_scan(combine, (decays, vals), axis=-1)
    return y[..., -1], y


def msk_ebno(mean, var):
    """MSK Eb/N0 estimate from matched-filter envelope mean/var.

    tebno = 10*(log10(2) - log10(var*alpha^2 - 0.0085)) - 5, alpha=sqrt(2)/mean
    (ref: decode/DSP.cpp:482-508; 0.0085 is the reference's calibration for the
    non-constant modulus after the matched filter).
    """
    alpha = jnp.sqrt(2.0) / jnp.maximum(mean, 1e-9)
    arg = var * alpha * alpha - 0.0085
    tebno = 10.0 * (jnp.log10(2.0) - jnp.log10(jnp.maximum(arg, 1e-9))) - 5.0
    return jnp.clip(jnp.nan_to_num(tebno, nan=50.0), -20.0, 50.0)
