"""Batched device-side P-channel frame decoding.

With many locked VFOs, per-VFO host Python framing can bound the station.
This module decodes BATCHES of aligned frames — from many VFOs and/or many
frames per VFO — in one jit call:

    deinterleave     gather with the static 64xN permutation
    Viterbi          vmapped ``lax.scan`` add-compare-select
                     (protocol/viterbi.py)
    descramble       XOR with the broadcast keystream row
    CRC-16           GF(2) affine map as a matmul: the CRC of an 80-bit SU
                     body is linear over GF(2), so
                     crc(m) = (m @ M) mod 2 xor crc(0)  (0/1 operands and
                     sums <= 80 are exact at any matmul precision)

Host code only finds UW alignments (cheap) and slices frames; all math is
dense.  Trellis continuity across frames is preserved by passing each
frame's 62-soft-bit history prefix (same economy as StreamingViterbi).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from aero_tpu.protocol.crc import crc16_bits
from aero_tpu.protocol.scrambler import SCRAMBLE_KEYSTREAM
from aero_tpu.protocol.interleaver import deinterleave_indices
from aero_tpu.protocol.framing import FRAME_SPECS
from aero_tpu.protocol.viterbi import viterbi_decode_soft

HISTORY = 62
LOOKAHEAD = 48


@functools.lru_cache(maxsize=None)
def _crc_matrix(nbits: int = 80):
    """M [nbits, 16] and c0 [16] with crc(m) = (m @ M) % 2 ^ c0 (bit k of
    the CRC in column k)."""
    c0 = crc16_bits(np.zeros(nbits, np.uint8))
    M = np.zeros((nbits, 16), np.float32)
    for i in range(nbits):
        e = np.zeros(nbits, np.uint8)
        e[i] = 1
        v = crc16_bits(e) ^ c0
        M[i] = [(v >> k) & 1 for k in range(16)]
    c0v = np.asarray([(c0 >> k) & 1 for k in range(16)], np.float32)
    return M, c0v


def crc16_check_batch(su_bits):
    """su_bits: [N, 96] 0/1 — returns bool [N] (body CRC == stored CRC)."""
    M, c0 = _crc_matrix(80)
    su_bits = jnp.asarray(su_bits, jnp.float32)
    calc = jnp.mod(su_bits[:, :80] @ jnp.asarray(M), 2.0)
    calc = jnp.mod(calc + jnp.asarray(c0), 2.0)
    # stored CRC: bits[80+k] = crc bit k (LSB-first byte layout)
    rec = su_bits[:, 80:96]
    return jnp.all(calc == rec, axis=1)


@functools.partial(jax.jit, static_argnames=("rate", "pre_deinterleaved"))
def batch_decode_p_frames(soft_payloads, prefixes, *, rate: int,
                          pre_deinterleaved: bool = False):
    """Decode N aligned P-channel frame payloads in one call.

    soft_payloads: [N, payload_soft_bits] soft bytes (after arm-flip
    correction); prefixes: [N, 62] soft bytes of the coded stream
    immediately before each payload (128s when unknown).  With
    ``pre_deinterleaved`` the payloads are already in coded-stream order
    (the framers' host prep deinterleaves, BatchPChannelFramerBank).

    Returns dict(info_bits [N, info], su_ok [N, n_su]).
    """
    spec = FRAME_SPECS[rate]
    N = soft_payloads.shape[0]
    blocklen = 64 * spec.cols

    if pre_deinterleaved:
        deint = jnp.asarray(soft_payloads, jnp.float32)
    else:
        didx = jnp.asarray(deinterleave_indices(spec.cols))
        payload = jnp.asarray(soft_payloads, jnp.float32).reshape(
            N, spec.blocks_per_frame, blocklen)
        deint = jnp.take(payload, didx, axis=2).reshape(N, -1)

    buf = jnp.concatenate(
        [jnp.asarray(prefixes, jnp.float32), deint,
         jnp.full((N, LOOKAHEAD), 128.0, jnp.float32)], axis=1)

    bits_all = jax.vmap(viterbi_decode_soft)(buf)

    h = HISTORY // 2
    info_scrambled = bits_all[:, h: h + spec.payload_info_bits]
    ks = jnp.asarray(SCRAMBLE_KEYSTREAM[: spec.payload_info_bits], jnp.uint8)
    info = jnp.bitwise_xor(info_scrambled.astype(jnp.uint8), ks)

    n_su = spec.payload_info_bits // 96
    su = info[:, : n_su * 96].reshape(N * n_su, 96)
    ok = crc16_check_batch(su).reshape(N, n_su)
    # all-zero SUs pass (ref: aerol.cpp:1537-1543)
    zeros = jnp.all(su == 0, axis=1).reshape(N, n_su)
    return {"info_bits": info, "su_ok": ok | zeros}


class BatchPChannelFramerBank:
    """Many same-rate P-channel framers with ONE batched device decode.

    Per-VFO lock search, arm-flip, UW scoring, DCD hysteresis and event
    bookkeeping stay in the (well-tested) PChannelFramer — run in
    ``defer_decode`` mode, where feed() queues prepared frames instead of
    decoding them.  ``flush()`` then decodes EVERY pending frame across
    all VFOs in one ``batch_decode_p_frames`` call (deinterleave already
    done on host; Viterbi + descramble + SU CRC on device) and replays
    each framer's bookkeeping in order.

    Semantics vs per-VFO sequential framing: identical on the same
    streams (tests/test_batch_framing.py::test_bank_matches_sequential),
    except the UW-mismatch relock decision sees the DCD as of the last
    drained batch (at most one frame stale).

    Off by default (``--batch-framing``): the sequential framers decode on
    the host with the native C++ Viterbi.  Which of the two wins at a
    given number of locked VFOs is a measurement of the served path.
    """

    def __init__(self, rate: int, topics):
        from aero_tpu.protocol.framing import PChannelFramer
        self.rate = rate
        self.framers = {}
        for t in topics:
            f = PChannelFramer(rate)
            f.defer_decode = True
            self.framers[t] = f

    def feed(self, rows: dict) -> dict:
        """rows: {topic: soft float array}.  Queues frames per topic, then
        batch-decodes everything pending.  Returns {topic: [FrameEvent]}."""
        for t, row in rows.items():
            evs = self.framers[t].feed(np.asarray(row, np.float32))
            assert not evs          # deferred mode never emits from feed
        return self.flush()

    def flush(self) -> dict:
        """Decode everything pending, replay bookkeeping, and iterate to a
        fixpoint: if a frame's bookkeeping LOSES the lock, frames of that
        VFO consumed after it are REWOUND (their raw bits go back to the
        framer's buffer and the UW search re-runs) — exactly what the
        sequential framer would have done mid-buffer, so a signal that
        resumes right after a dropout is re-acquired without losing a
        frame (caught by a 50-seed fuzz, 2026-08-21)."""
        from aero_tpu.protocol.framing import bits_to_bytes_lsb
        out = {t: [] for t in self.framers}
        while True:
            pend = [(t, pre) for t, f in self.framers.items()
                    for pre in f._pending]
            if not pend:
                return out
            soft = np.stack([pre["soft"] for _, pre in pend])
            prefixes = np.stack([pre["prefix"] for _, pre in pend])
            # pad the batch to the next power of two so the jit cache
            # stays bounded as the per-drain frame count fluctuates
            n = len(pend)
            n_pad = 1 << (n - 1).bit_length()
            if n_pad > n:
                soft = np.concatenate(
                    [soft, np.full((n_pad - n,) + soft.shape[1:], 128.0,
                                   soft.dtype)])
                prefixes = np.concatenate(
                    [prefixes,
                     np.full((n_pad - n,) + prefixes.shape[1:], 128.0,
                             prefixes.dtype)])
            dec = batch_decode_p_frames(
                jnp.asarray(soft), jnp.asarray(prefixes), rate=self.rate,
                pre_deinterleaved=True)
            info_bits = np.asarray(dec["info_bits"])
            su_ok = np.asarray(dec["su_ok"])

            idx = 0
            rewound = False
            by_topic = {t: [] for t in self.framers}
            for t, pre in pend:
                by_topic[t].append((idx, pre))
                idx += 1
            for t, items in by_topic.items():
                f = self.framers[t]
                f._pending.clear()
                for k, (i, pre) in enumerate(items):
                    out[t].append(f._finish_frame(
                        pre, bits_to_bytes_lsb(info_bits[i]), su_ok[i]))
                    if not f.locked:
                        # lock lost at finish time: un-consume the later
                        # frames AND re-expose the lock-losing frame's
                        # trailing UW region (the sequential feed() does
                        # this on its lock-loss path, framing.py — a
                        # timing slip shifts the boundary a few bits and
                        # relock must land on the SHIFTED UW, not a
                        # whole frame later), then re-run the UW search
                        kk = len(f._uw_pattern) + 16
                        later = [p["raw"] for _, p in items[k + 1:]]
                        f.buf = np.concatenate(
                            [pre["raw"][-kk:]] + later + [f.buf])
                        evs = f.feed(np.zeros(0, np.float32))
                        assert not evs
                        if later:
                            rewound = True
                            break
            if not rewound:
                return out
