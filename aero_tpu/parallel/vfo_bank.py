"""Batched multi-VFO demodulation, sharded over a device mesh.

This is the replacement for the reference's one-process-per-VFO model
(ref: decode/main.cpp + ZMQ topic per VFO): a bank of B MSK demodulators is a
single jitted step vmapped over the leading axis and sharded over the mesh's
``vfo`` axis.  All VFOs advance in lock-step on dense blocks; soft bits come
back [B, bits/block] for the host-side deframers.
"""

from __future__ import annotations


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from aero_tpu.models.msk import make_config, msk_init, msk_step
from aero_tpu.ops.compat import tree_pack, tree_unpack
from aero_tpu.parallel.mesh import make_mesh, shard_over_vfo


class VfoBank:
    """B independent demodulators of one model as a sharded, jitted step."""

    _make_config = staticmethod(make_config)
    _init = staticmethod(msk_init)
    _step = staticmethod(msk_step)

    def __init__(self, n_vfos: int, fs: float, fb: float,
                 mesh: Mesh | None = None, donate: bool = True, **kw):
        make_config, msk_init, msk_step = (self._make_config, self._init,
                                           self._step)
        self.cfg = make_config(fs, fb, **kw)
        self.n = n_vfos
        if mesh is None:
            # the vfo axis must divide the batch; use the largest device
            # count that does
            n_dev = len(jax.devices())
            while n_vfos % n_dev:
                n_dev -= 1
            mesh = make_mesh(n_dev)
        self.mesh = mesh
        cfg = self.cfg
        # states cross the jit boundary packed (complex leaves as float32
        # [2, ...] pairs, ops/compat.py), and the initial state is built
        # INSIDE a no-input jit
        states = jax.jit(lambda: jax.vmap(
            lambda _: tree_pack(msk_init(cfg)))(jnp.arange(n_vfos)))()
        self.states = shard_over_vfo(self.mesh, states)

        def step(packed, samples):
            def one(p, x):
                s2, out = msk_step(tree_unpack(p), x, cfg)
                return tree_pack(s2), out
            return jax.vmap(one)(packed, samples)

        self._jit_step = jax.jit(step, donate_argnums=(0,) if donate else ())

    def process_block(self, samples: np.ndarray):
        """samples: [n_vfos, block_len] real float32.  Returns outputs dict
        with leading vfo axis."""
        samples = jax.device_put(
            jnp.asarray(samples, jnp.float32),
            NamedSharding(self.mesh, P("vfo", None)))
        self.states, out = self._jit_step(self.states, samples)
        return out

    def retune(self, rows, freqs):
        """Force the demodulators in ``rows`` to re-acquire at the given
        audio center frequencies (the reference's CenterFreqChangedSlot;
        ref: decode/decode.cpp:183-226).  Hunting fires rarely, so the
        fetch-modify-put round trip is off the hot path."""
        # states were packed per-VFO under vmap, so the complex-pack axis
        # sits at position 1 — unpack/repack under vmap to keep the vfo
        # axis leading
        st = jax.vmap(tree_unpack)(self.states)
        rows = np.asarray(rows, np.int64)
        freqs = jnp.asarray(np.asarray(freqs, np.float32))
        st = st._replace(
            freq=st.freq.at[rows].set(freqs),
            mse=st.mse.at[rows].set(2.0),
            have_lock_refs=st.have_lock_refs.at[rows].set(False),
            agc_ema=st.agc_ema.at[rows].set(0.0),
            coarse_y=st.coarse_y.at[rows].set(20.0),
            # the Doppler slope / clock-rate carries belong to the OLD
            # signal: a stale 100 Hz/s slope would chirp the hunted band
            # and block re-acquisition there
            slope=st.slope.at[rows].set(0.0),
            grid_rate=st.grid_rate.at[rows].set(0.0))
        self.states = shard_over_vfo(self.mesh, jax.vmap(tree_pack)(st))


class MskVfoBank(VfoBank):
    """B independent MSK demodulators (600/1200 bps)."""


from aero_tpu.models import oqpsk as _oqpsk_mod


class OqpskVfoBank(VfoBank):
    """B independent OQPSK demodulators (8400/10500 bps)."""
    _make_config = staticmethod(_oqpsk_mod.make_config)
    _init = staticmethod(_oqpsk_mod.oqpsk_init)
    _step = staticmethod(_oqpsk_mod.oqpsk_step)
