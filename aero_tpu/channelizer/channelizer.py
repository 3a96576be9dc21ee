"""Batched block channelizer: wideband IQ -> per-topic payloads.

Block-vectorized replacement for the reference's per-sample VFO tree
(ref: publish/vfo.cpp:154-313): all main VFOs process the same wideband
block vmapped over their mix frequencies; each group of like-shaped sub VFOs
is vmapped over its members.  Every filter carries overlap state, so output
streams are bit-continuous across blocks.

Per-VFO chains (matching the reference semantics):
  main: NCO mix (center - rf) -> halfband^k               (vfo.cpp:154-165)
        publish as 4-bit-packed IQ nibbles (cstyle 1)     (vfo.cpp:262-275)
  sub:  NCO mix (main_rf - rf) -> halfband^k
        [-> lowpass decimate x5/x6]                       (vfo.cpp:216-258)
        -> USB demod: delay(Re) - hilbert(Im)             (vfo.cpp:188-214)
        [-> audio lowpass filter_bw]
        -> gain * 32768 -> int16 audio
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import jax
import jax.numpy as jnp

from aero_tpu.ops import (nco_init, fir_init, fir_apply, fir_decimate_init,
                          fir_decimate_apply, HALFBAND_TAPS, low_pass_design,
                          hilbert_design)
from aero_tpu.ops.nco import nco_mix
from aero_tpu.ops.fir import delay_init, delay_apply
from aero_tpu.channelizer.config import ChannelizerConfig
from aero_tpu import native
from aero_tpu.ops.compat import tree_pack, tree_unpack, pack_c64, unpack_c64

_HB = HALFBAND_TAPS[11].astype(np.float32)   # vfo.init uses 11 taps (vfo.cpp:106-108)
_HILBERT_NTAPS = 125                          # vfo.cpp:112


def dc_correct_python(iq: np.ndarray, alpha: float,
                      state: np.ndarray) -> np.ndarray:
    """Exact one-pole DC tracker, vectorized (scipy lfilter).

    Same recurrence as ``native.dc_correct_native`` / the reference
    (publisher.cpp:292-296): ``dc += alpha*(x-dc); y = x-dc``, i.e.
    ``dc[n] = alpha*x[n] + (1-alpha)*dc[n-1]`` with lfilter initial state
    ``zi = (1-alpha)*dc_prev``.  ``state`` is the float32 [2] {re, im}
    carry shared with the native path, updated in place.  Returns a new
    complex64 array.
    """
    from scipy.signal import lfilter
    d0 = complex(state[0], state[1])
    dc, _ = lfilter(np.asarray([alpha], np.float32),
                    np.asarray([1.0, -(1.0 - alpha)], np.float32),
                    iq, zi=np.asarray([(1.0 - alpha) * d0], np.complex64))
    out = (iq - dc).astype(np.complex64)
    last = dc[-1] if len(dc) else d0
    state[0] = np.float32(last.real)
    state[1] = np.float32(last.imag)
    return out


def _chain_init(decim_count: int, usb: bool, late: int, ntaps_late: int,
                ntaps_post: int):
    st = {
        "nco": nco_init(),
        "hb": [fir_decimate_init(len(_HB), dtype=jnp.complex64)
               for _ in range(decim_count)],
    }
    if late:
        st["late"] = fir_decimate_init(ntaps_late, dtype=jnp.complex64)
    if usb:
        st["hilb"] = fir_init(_HILBERT_NTAPS)
        st["dly"] = delay_init((_HILBERT_NTAPS - 1) // 2)
        if ntaps_post:
            st["post"] = fir_init(ntaps_post)
    return st


class Channelizer:
    """Host driver around jitted per-group VFO chains."""

    def __init__(self, cfg: ChannelizerConfig):
        self.cfg = cfg
        self.fs = cfg.sample_rate
        self._dc_state = np.zeros(2, np.float32)   # per-sample DC carry

        # ---- main VFO groups by decim_count ----
        self.main_groups = defaultdict(list)     # decim -> [main indices]
        for i, m in enumerate(cfg.mains):
            self.main_groups[m.decim_count].append(i)
        self._main_state = {}
        self._main_freqs = {}
        for decim, idxs in self.main_groups.items():
            freqs = np.array([(cfg.center_frequency - cfg.mains[i].freq)
                              / self.fs for i in idxs], np.float32)
            self._main_freqs[decim] = jnp.asarray(freqs)
            n = len(idxs)
            self._main_state[decim] = jax.jit(
                lambda n=n, d=decim: jax.vmap(lambda _: tree_pack(
                    _chain_init(d, usb=False, late=0, ntaps_late=0,
                                ntaps_post=0)))(jnp.arange(n)))()

        # ---- sub VFO groups ----
        # group key: (main_idx, decim, late, filter_bw, out_rate)
        self.sub_groups = defaultdict(list)
        for i, s in enumerate(cfg.subs):
            key = (s.main_idx, s.decim_count, s.late_decimate, s.filter_bw,
                   s.out_rate)
            self.sub_groups[key].append(i)
        self._sub_state = {}
        self._sub_freqs = {}
        self._sub_gains = {}
        self._sub_late_taps = {}
        self._sub_post_taps = {}
        for key, idxs in self.sub_groups.items():
            main_idx, decim, late, filter_bw, out_rate = key
            main_rf = (cfg.mains[main_idx].freq if main_idx >= 0
                       else cfg.center_frequency)
            in_rate = (cfg.mains[main_idx].out_rate if main_idx >= 0
                       else self.fs)
            freqs = np.array([(main_rf - cfg.subs[i].freq) / in_rate
                              for i in idxs], np.float32)
            self._sub_freqs[key] = jnp.asarray(freqs)
            self._sub_gains[key] = jnp.asarray(
                [cfg.subs[i].gain for i in idxs], np.float32)
            ntaps_late = 0
            if late:
                target = out_rate
                taps = low_pass_design(2.0, target * late, target / 2,
                                       target / (late - 1)).astype(np.float32)
                self._sub_late_taps[key] = taps
                ntaps_late = len(taps)
            ntaps_post = 0
            if filter_bw > 0:
                taps = low_pass_design(2.0, out_rate, filter_bw,
                                       filter_bw / 4).astype(np.float32)
                self._sub_post_taps[key] = taps   # numpy (see above)
                ntaps_post = len(taps)
            n = len(idxs)
            self._sub_state[key] = jax.jit(
                lambda n=n, d=decim, l=late, nl=ntaps_late, np_=ntaps_post:
                jax.vmap(lambda _: tree_pack(_chain_init(
                    d, usb=True, late=l, ntaps_late=nl, ntaps_post=np_)))(
                        jnp.arange(n)))()

        self._jit_main = {}
        self._jit_sub = {}

    # ---- jitted group steps ----

    def _main_step(self, decim):
        # every jit boundary is complex-free (ops/compat.py): wideband and
        # channel outputs cross as float32 [2, T] pairs, filter states as
        # packed trees
        if decim not in self._jit_main:
            def one(stp, x2, f):
                st = tree_unpack(stp)
                new = dict(st)
                new["nco"], z = nco_mix(st["nco"], unpack_c64(x2), f)
                hb = []
                for s in st["hb"]:
                    s, z = fir_decimate_apply(s, z, jnp.asarray(_HB), 2)
                    hb.append(s)
                new["hb"] = hb
                return tree_pack(new), pack_c64(z)
            self._jit_main[decim] = jax.jit(
                jax.vmap(one, in_axes=(0, None, 0)))
        return self._jit_main[decim]

    def _sub_step(self, key):
        if key not in self._jit_sub:
            main_idx, decim, late, filter_bw, out_rate = key
            late_taps = self._sub_late_taps.get(key)
            post_taps = self._sub_post_taps.get(key)
            hilb_taps = hilbert_design(_HILBERT_NTAPS).astype(np.float32)

            def one(stp, x2, f, g):
                st = tree_unpack(stp)
                new = dict(st)
                new["nco"], z = nco_mix(st["nco"], unpack_c64(x2), f)
                hb = []
                for s in st["hb"]:
                    s, z = fir_decimate_apply(s, z, jnp.asarray(_HB), 2)
                    hb.append(s)
                new["hb"] = hb
                if late:
                    new["late"], z = fir_decimate_apply(
                        st["late"], z, jnp.asarray(late_taps), late)
                new["hilb"], h = fir_apply(st["hilb"], z.imag,
                                           jnp.asarray(hilb_taps))
                new["dly"], d = delay_apply(st["dly"], z.real)
                audio = d - h
                if post_taps is not None:
                    new["post"], audio = fir_apply(st["post"], audio,
                                                   jnp.asarray(post_taps))
                pcm = jnp.clip(audio * g * 32768.0,
                               -32767.0, 32767.0).astype(jnp.int16)
                return tree_pack(new), pcm

            self._jit_sub[key] = jax.jit(jax.vmap(one, in_axes=(0, None, 0, 0)))
        return self._jit_sub[key]

    # ---- host driver ----

    def process(self, iq: np.ndarray) -> list:
        """iq: complex64 [T] wideband block (T divisible by every VFO's total
        decimation).  Returns [(topic, out_rate, payload_bytes), ...].
        """
        iq = np.asarray(iq, np.complex64)
        if self.cfg.correct_dc_bias:
            # one-pole DC tracker, alpha = 1e-6 (ref: publisher.cpp:292-296)
            alpha = 1e-6
            if native.have_native_ingest():
                # exact per-sample form (native/ingest.cc aero_dc_correct);
                # copy first — the C routine corrects in place
                iq = iq.copy()
                native.dc_correct_native(iq, alpha, self._dc_state)
            else:
                # exact same recurrence, vectorized via scipy — both paths
                # produce the same stream up to float32 rounding, so decode
                # output is host-environment independent (ADVICE r3)
                iq = dc_correct_python(iq, alpha, self._dc_state)

        x2 = jnp.asarray(np.stack([iq.real, iq.imag]))   # float pair
        outputs = []

        main_out = {}          # main idx -> float [2, T'] device array
        for decim, idxs in self.main_groups.items():
            step = self._main_step(decim)
            self._main_state[decim], z2 = step(self._main_state[decim], x2,
                                               self._main_freqs[decim])
            for row, i in enumerate(idxs):
                main_out[i] = z2[row]
                m = self.cfg.mains[i]
                if m.topic:
                    zr = np.asarray(z2[row])
                    payload = self._compress_nibbles(zr[0] + 1j * zr[1],
                                                     m.compress_scale)
                    outputs.append((m.topic, m.out_rate, payload))

        for key, idxs in self.sub_groups.items():
            main_idx = key[0]
            src = x2 if main_idx < 0 else main_out[main_idx]
            step = self._sub_step(key)
            self._sub_state[key], pcm = step(self._sub_state[key], src,
                                             self._sub_freqs[key],
                                             self._sub_gains[key])
            pcm = np.asarray(pcm)
            for row, i in enumerate(idxs):
                s = self.cfg.subs[i]
                outputs.append((s.topic, s.out_rate,
                                pcm[row].astype("<i2").tobytes()))
        return outputs

    @staticmethod
    def _compress_nibbles(z: np.ndarray, scale: int) -> bytes:
        """cstyle 1: keep the top nibble of each scaled arm
        (ref: vfo.cpp:262-275)."""
        re = np.clip((z.real / scale) * 128.0, -128, 127).astype(np.int8)
        im = np.clip((z.imag / scale) * 128.0, -128, 127).astype(np.int8)
        packed = (re.astype(np.uint8) & 0xF0) | ((im.astype(np.uint8) & 0xF0) >> 4)
        return packed.astype(np.uint8).tobytes()
