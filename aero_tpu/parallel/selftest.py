"""Multi-process (multi-host) self-test worker.

Run one instance per "host" (process); together they form a global device
mesh and execute the time-sharded wideband filter with cross-process halo
exchange, then verify the sharded result is bit-identical to a local
unsharded reference.  This is the N-host scaling test the reference never
had (SURVEY.md §4: "multi-host tests via jax multi-process on CPU
backends — none of which exist in the reference").

Usage (one line per process, same coordinator):

    python -m aero_tpu.parallel.selftest --process-id 0 --num-processes 2
    python -m aero_tpu.parallel.selftest --process-id 1 --num-processes 2

On multi-device hosts, drop --devices-per-process and let jax find them;
on CPU hosts each process fakes --devices-per-process virtual devices.
Exit code 0 and a final "MH-SELFTEST-OK" line mean success.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="127.0.0.1:29621")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--devices-per-process", type=int, default=4,
                    help="virtual CPU devices per process (0 = real chips)")
    ap.add_argument("--samples-per-device", type=int, default=8192)
    args = ap.parse_args(argv)

    if args.devices_per_process:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                        f"{args.devices_per_process}").strip()

    import numpy as np
    import jax
    if args.devices_per_process:
        jax.config.update("jax_platforms", "cpu")

    from aero_tpu.parallel.multihost import (init_distributed,
                                             scatter_time_shards,
                                             gather_to_hosts)
    from aero_tpu.parallel.time_shard import halo_filter_time_sharded
    from aero_tpu.ops.design import HALFBAND_TAPS
    from jax.sharding import Mesh

    init_distributed(args.coordinator, args.num_processes, args.process_id)
    devs = np.array(jax.devices())
    mesh = Mesh(devs, ("time",))
    n_local = jax.local_device_count()
    per_dev = args.samples_per_device
    local_n = n_local * per_dev
    total = len(devs) * per_dev

    # deterministic global signal; each process materializes only its slice
    def sig(i0, n):
        t = np.arange(i0, i0 + n, dtype=np.float64)
        return (np.sin(2 * np.pi * 0.01 * t)
                + 0.25 * np.sin(2 * np.pi * 0.07 * t + 0.5)
                ).astype(np.float32)

    start = args.process_id * local_n
    local = sig(start, local_n)
    g = scatter_time_shards(mesh, local)

    taps = HALFBAND_TAPS[23].astype(np.float32)
    fn = halo_filter_time_sharded(mesh, taps)
    y = gather_to_hosts(fn(g))

    ref = np.convolve(sig(0, total), taps, mode="full")[:total]
    err = float(np.max(np.abs(y - ref)))
    ok = err < 1e-4
    print(f"MH-SELFTEST-{'OK' if ok else 'FAIL'} proc={args.process_id} "
          f"procs={args.num_processes} devices={len(devs)} "
          f"samples={total} max_err={err:.2e}", flush=True)

    # aggregate throughput on the N-process mesh (BASELINE 'measured at
    # N>=2 hosts'; virtual CPU devices here, so this records the
    # cross-process program's rate, not chip speed)
    import time as _time
    gx = scatter_time_shards(mesh, local)
    r = fn(gx)
    jax.block_until_ready(r)
    t0 = _time.perf_counter()
    iters = 20
    for _ in range(iters):
        r = fn(gx)
    jax.block_until_ready(r)
    dt = _time.perf_counter() - t0
    print(f"MH-THROUGHPUT proc={args.process_id} "
          f"{iters * total / dt / 1e6:.1f} MS/s aggregate over "
          f"{args.num_processes} processes", flush=True)

    # ---- stage 1b: time-sharded WOLA channelizer across processes ----
    # The PFB's filter history crosses the process boundary as a ppermute
    # halo; result must be bit-identical to the local unsharded pass.
    from aero_tpu.channelizer.pfb import pfb_channelize, pfb_init
    from aero_tpu.parallel.time_shard import pfb_channelize_time_sharded
    import jax.numpy as _jnp

    Kp = 32
    Mp = Kp // 2
    Tp = len(devs) * Mp * 24
    prng = np.random.default_rng(5)
    xg = (prng.standard_normal(Tp)
          + 1j * prng.standard_normal(Tp)).astype(np.complex64)
    pfn = pfb_channelize_time_sharded(mesh, Kp)
    from jax.experimental import multihost_utils as _mh
    from jax.sharding import PartitionSpec as _P
    lo_t = args.process_id * (Tp // args.num_processes)
    x_loc = xg[lo_t: lo_t + Tp // args.num_processes]
    x_gl = _mh.host_local_array_to_global_array(x_loc, mesh, _P("time"))
    z_sh = np.asarray(_mh.process_allgather(
        pfn(pfb_init(Kp), x_gl), tiled=True))
    _, z_ref = pfb_channelize(pfb_init(Kp), _jnp.asarray(xg), Kp)
    ok1b = bool(np.array_equal(z_sh, np.asarray(z_ref)))
    print(f"MH-PFBTIME-{'OK' if ok1b else 'FAIL'} proc={args.process_id} "
          f"K={Kp} T={Tp}", flush=True)

    # ---- stage 2: VFO-sharded demod bank across processes ----
    # The framework's primary scaling axis (SURVEY.md §2.5): one MSK
    # demod bank whose VFO rows live on different HOSTS, stepped as one
    # jit program over the global mesh, verified against an unsharded
    # per-row local reference.
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    from jax.sharding import PartitionSpec as P
    from aero_tpu.models.msk import (make_config, msk_init, msk_step,
                                     msk_modulate)

    vmesh = Mesh(devs, ("vfo",))
    B = len(devs)
    b_local = n_local
    cfg = make_config(24000.0, 1200.0, block_len=4800, nfft=4096,
                      fine_step_hz=1.0)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, 700).astype(np.uint8)
    one = msk_modulate(bits, 24000.0, 1200.0)[: 2 * cfg.block_len]
    amps = (0.5 + 0.05 * np.arange(B)).astype(np.float32)
    lo = args.process_id * b_local
    local_rows = amps[lo: lo + b_local, None] * one[None, :]

    def to_global(local_leaf):
        a = np.asarray(local_leaf)
        return multihost_utils.host_local_array_to_global_array(
            a, vmesh, P("vfo", *([None] * (a.ndim - 1))))

    states = jax.tree.map(to_global,
                          jax.vmap(lambda _: msk_init(cfg))(
                              jnp.arange(b_local)))

    @jax.jit
    def bank_step(states, samples):
        return jax.vmap(lambda s, x: msk_step(s, x, cfg))(states, samples)

    softs = []
    for blk in range(2):
        x = to_global(local_rows[:, blk * cfg.block_len:
                                 (blk + 1) * cfg.block_len])
        states, out = bank_step(states, x)
        softs.append(gather_to_hosts(out["soft_bits"]))
    got = np.concatenate(softs, axis=-1)          # [B, bits]

    # unsharded per-row local reference
    ref_rows = []
    for r in range(B):
        st = msk_init(cfg)
        row = []
        for blk in range(2):
            st, out = msk_step(st, amps[r] * one[blk * cfg.block_len:
                                                 (blk + 1) * cfg.block_len],
                               cfg)
            row.append(np.asarray(out["soft_bits"]))
        ref_rows.append(np.concatenate(row))
    ref2 = np.stack(ref_rows)
    # float reassociation under vmap/sharding can flip a rounded soft
    # byte by 1 at quantization boundaries — demand near-exactness
    close = np.abs(got.astype(int) - ref2.astype(int)) <= 1
    ok2 = bool(close.mean() > 0.999)
    print(f"MH-VFOBANK-{'OK' if ok2 else 'FAIL'} proc={args.process_id} "
          f"rows={B} match={100.0 * close.mean():.2f}%", flush=True)

    # ---- scaling efficiency: the SAME bank workload 1-process vs
    # N-process (VERDICT r4 item 5) — BASELINE's "near-linear 1->N
    # hosts" gets a measured number.  Each process measures its
    # single-process rate ALONE (barrier-serialized, so the other
    # process's activity cannot deflate the baseline and flatter the
    # ratio), then all processes time the global-mesh bank together.
    import time as _t

    def _time_bank(states0, x, iters=30):
        s_, out = bank_step(states0, x)
        jax.block_until_ready(out)
        t0 = _t.perf_counter()
        for _ in range(iters):
            s_, out = bank_step(s_, x)
        jax.block_until_ready(out)
        return iters / (_t.perf_counter() - t0)

    from jax.sharding import NamedSharding

    lmesh = Mesh(np.array(jax.local_devices()), ("vfo",))

    def l_shard(leaf):
        leaf = jnp.asarray(leaf)
        spec = P("vfo", *([None] * (leaf.ndim - 1))) if leaf.ndim else P()
        return jax.device_put(leaf, NamedSharding(lmesh, spec))

    rate1 = 0.0
    for turn in range(args.num_processes):
        multihost_utils.sync_global_devices(f"scal-local-{turn}")
        if turn == args.process_id:
            lstates = jax.tree.map(l_shard, jax.vmap(
                lambda _: msk_init(cfg))(jnp.arange(b_local)))
            lx = jax.device_put(
                jnp.asarray(local_rows[:, :cfg.block_len]),
                NamedSharding(lmesh, P("vfo", None)))
            rate1 = _time_bank(lstates, lx) * b_local * cfg.block_len
    multihost_utils.sync_global_devices("scal-global")
    gstates = jax.tree.map(to_global, jax.vmap(
        lambda _: msk_init(cfg))(jnp.arange(b_local)))
    gx = to_global(local_rows[:, :cfg.block_len])
    rateN = _time_bank(gstates, gx) * B * cfg.block_len
    eff = rateN / (args.num_processes * rate1)
    print(f"MH-SCALING proc={args.process_id} single={rate1 / 1e6:.1f} "
          f"MS/s ({b_local} rows) aggregate={rateN / 1e6:.1f} MS/s "
          f"({B} rows over {args.num_processes} procs) "
          f"efficiency={100.0 * eff:.0f}%", flush=True)

    # ---- stage 3: the FULL FusedStation across processes ----
    # The production station program (quantized ingest -> PFB -> vmapped
    # demod bank -> packed soft+telemetry) compiled over the GLOBAL mesh,
    # VFO rows living on different hosts, verified against a local
    # unsharded run of the same block (VERDICT r3 item 6).
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime.fused_station import FusedStation

    n_v = len(devs)
    vfos = "".join(
        f"{i+1}\\frequency={1545002000 + i * 19000}\n"
        f"{i+1}\\data_rate=1200\n{i+1}\\topic=V{i}\n{i+1}\\gain=100\n"
        for i in range(n_v))
    ini = ("[General]\nsample_rate=1536000\ncenter_frequency=1545000000\n"
           f"[vfos]\nsize={n_v}\n{vfos}")

    def mk():
        return FusedStation(load_ini(ini, is_text=True),
                            ingest_dtype="int4", base_block=160,
                            pipeline=False, hunt=False)

    st = mk()
    srng = np.random.default_rng(7)
    blk = st.quantize((0.02 * (srng.standard_normal((st.block_len, 2))
                               @ [1, 1j])).astype(np.complex64))

    # globalize the station state over the process-spanning mesh: per-VFO
    # leaves sharded on their leading row axis (each host contributes its
    # local rows of the deterministic init), PFB carries replicated —
    # exactly FusedStation.shard's layout, built cross-host
    def g_vfo(leaf):
        a = np.asarray(leaf)
        loc = a[args.process_id * b_local:(args.process_id + 1) * b_local]
        return multihost_utils.host_local_array_to_global_array(
            loc, vmesh, P("vfo", *([None] * (a.ndim - 1))))

    def g_rep(leaf):
        return multihost_utils.host_local_array_to_global_array(
            np.asarray(leaf), vmesh, P())

    st._state = {
        "pfb": {r: g_rep(v) for r, v in st._state["pfb"].items()},
        "grp": {key: jax.tree.map(g_vfo, g)
                for key, g in st._state["grp"].items()},
    }
    step = st._get_step(1)
    iqs = g_rep(np.stack([np.asarray(blk)]))
    scales = g_rep(np.asarray([1.0], np.float32))
    st._state, packed = step(st._state, iqs, scales)
    got3 = np.asarray(multihost_utils.process_allgather(packed, tiled=True))

    ref_st = mk()                      # local, unsharded reference
    _, ref_packed = ref_st._get_step(1)(
        ref_st._state, jnp.asarray(np.stack([np.asarray(blk)])),
        jnp.asarray([1.0], jnp.float32))
    ref_row = np.asarray(ref_packed)[0]
    got_row = got3[0]
    soft_n = ref_st._soft_total
    # soft bytes: rounding at quantization boundaries may flip by 1 under
    # resharded reductions; telemetry floats must agree closely
    soft_close = (np.abs(got_row[:soft_n].astype(int)
                         - ref_row[:soft_n].astype(int)) <= 1).mean()
    tel_ok = np.allclose(got_row[soft_n:].view(np.float32),
                         ref_row[soft_n:].view(np.float32),
                         rtol=1e-4, atol=1e-4)
    ok3 = bool(tel_ok and soft_close > 0.999)
    print(f"MH-FUSEDSTATION-{'OK' if ok3 else 'FAIL'} "
          f"proc={args.process_id} vfos={n_v} "
          f"soft_match={100.0 * soft_close:.2f}% tel_match={tel_ok}",
          flush=True)
    return 0 if (ok and ok1b and ok2 and ok3) else 1


if __name__ == "__main__":
    sys.exit(main())
