"""Batched soft-decision Viterbi for the Aero-L convolutional code.

K=7, rate 1/2, polynomials {109, 79} (ref: decode/aerol.cpp:909-913 feeding
libcorrect; decode/jconvolutionalcodec.cpp:10-16).  The reference calls
libcorrect's sequential C decoder one block at a time; here the
add-compare-select recursion runs as a ``lax.scan`` over time with all 64
states updated as one vectorized gather/min — and vmaps over a leading batch
axis so hundreds of frames/VFOs decode in one launch.

Convention (self-consistent with ``conv_encode``): the shift register takes
the newest bit at the LSB (r = ((r<<1)|b) & 0x7F), output bit i =
parity(r & poly[i]), emitted poly order (109, 79).  Soft bits are bytes:
0 = strong zero, 255 = strong one, 128 = erasure/neutral.

Streaming (Decode_Continuous-equivalent, ref jconvolutionalcodec.cpp:146-198):
``StreamingViterbi`` carries a 62-soft-bit history between chunks and pads 48
neutral soft bits of lookahead, returning exactly the decoded bits aligned to
each chunk.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

POLYS = (109, 79)
K = 7
NSTATES = 64


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint32)
    x ^= x >> 16
    x ^= x >> 8
    x ^= x >> 4
    x ^= x >> 2
    x ^= x >> 1
    return (x & 1).astype(np.uint8)


@functools.lru_cache(maxsize=None)
def _tables(polys=POLYS):
    """Static transition tables.

    PRED[ns, j]    : the two predecessor states of next-state ns
    PATTERN[ns, j] : expected output pair (o0*2+o1) on that transition
    """
    pred = np.empty((NSTATES, 2), dtype=np.int32)
    pattern = np.empty((NSTATES, 2), dtype=np.int32)
    for ns in range(NSTATES):
        b = ns & 1
        for j, ps in enumerate((ns >> 1, (ns >> 1) | 0x20)):
            reg = ((ps << 1) | b) & 0x7F
            o0 = int(_parity(np.uint32(reg & polys[0])))
            o1 = int(_parity(np.uint32(reg & polys[1])))
            pred[ns, j] = ps
            pattern[ns, j] = o0 * 2 + o1
    return pred, pattern


def conv_encode(bits, polys=POLYS, init_register: int = 0) -> np.ndarray:
    """Encode bits -> 2x coded bits (numpy, used by the modulator/tests)."""
    bits = np.asarray(bits, dtype=np.uint8)
    out = np.empty(2 * len(bits), dtype=np.uint8)
    r = init_register & 0x7F
    for i, b in enumerate(bits):
        r = ((r << 1) | int(b)) & 0x7F
        out[2 * i] = _parity(np.uint32(r & polys[0]))
        out[2 * i + 1] = _parity(np.uint32(r & polys[1]))
    return out


@functools.partial(jax.jit, static_argnames=("known_start",))
def viterbi_decode_soft(soft, known_start: bool = False):
    """Decode one stream of soft bytes [2T] -> hard bits [T] (JAX).

    soft: float/int array, 0..255 (255 = strong one).
    known_start: assume the encoder register started at 0.
    """
    pred_np, pattern_np = _tables()
    pred = jnp.asarray(pred_np)
    pattern = jnp.asarray(pattern_np)

    soft = jnp.asarray(soft, jnp.float32).reshape(-1, 2)  # [T, 2]
    # branch metric for each expected pair (00,01,10,11):
    # |s0 - e0*255| + |s1 - e1*255|
    s0 = soft[:, 0]
    s1 = soft[:, 1]
    bm = jnp.stack(
        [s0 + s1, s0 + (255.0 - s1), (255.0 - s0) + s1, (255.0 - s0) + (255.0 - s1)],
        axis=-1)  # [T, 4]

    if known_start:
        pm0 = jnp.full((NSTATES,), 1e9, jnp.float32).at[0].set(0.0)
    else:
        pm0 = jnp.zeros((NSTATES,), jnp.float32)

    def step(pm, bm_t):
        cand = pm[pred] + bm_t[pattern]          # [64, 2]
        surv = jnp.argmin(cand, axis=1)          # [64]
        pm_new = jnp.min(cand, axis=1)
        pm_new = pm_new - jnp.min(pm_new)        # normalize
        return pm_new, surv.astype(jnp.int8)

    pm_final, survivors = lax.scan(step, pm0, bm)   # survivors [T, 64]

    end_state = jnp.argmin(pm_final).astype(jnp.int32)

    def back(state, surv_t):
        bit = (state & 1).astype(jnp.uint8)
        prev = pred[state, surv_t[state]]
        return prev, bit

    _, bits_rev = lax.scan(back, end_state, survivors, reverse=True)
    return bits_rev


viterbi_decode_soft_batch = jax.jit(
    jax.vmap(lambda s: viterbi_decode_soft(s)), static_argnums=())


class StreamingViterbi:
    """Continuous decoding with history carry, aligned to chunk boundaries.

    Each call decodes one chunk of soft bytes (even length) and returns
    len(chunk)//2 bits corresponding exactly to that chunk.  62 soft bits of
    history warm the trellis; 48 neutral soft bits give the tail lookahead
    (matching the reference's overlap/padding economy,
    ref: jconvolutionalcodec.cpp:146-198).
    """

    HISTORY = 62
    LOOKAHEAD = 48

    def __init__(self):
        self._carry = np.full(self.HISTORY, 128, dtype=np.float32)

    def reset(self):
        self._carry[:] = 128

    def decode(self, soft_chunk) -> np.ndarray:
        soft_chunk = np.asarray(soft_chunk, dtype=np.float32)
        assert soft_chunk.size % 2 == 0
        buf = np.concatenate(
            [self._carry, soft_chunk,
             np.full(self.LOOKAHEAD, 128, dtype=np.float32)])
        # single-frame host decodes go through the native C++ decoder when
        # available (aero_tpu/native, the libcorrect replacement); batched
        # device decodes vmap viterbi_decode_soft (protocol/batch_framing)
        from aero_tpu import native
        if native.have_native():
            bits = native.viterbi_decode_soft_native(buf)
        else:
            bits = np.asarray(viterbi_decode_soft(jnp.asarray(buf)))
        self._carry = soft_chunk[-self.HISTORY:].copy() if soft_chunk.size >= self.HISTORY \
            else np.concatenate([self._carry, soft_chunk])[-self.HISTORY:]
        h = self.HISTORY // 2
        return bits[h: h + soft_chunk.size // 2]
