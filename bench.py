"""Benchmarks on one GPU.  Prints ONE JSON line to stdout (headline:
full-chain wideband throughput); extra metrics go to stderr.

Headline: the full chain — one wideband 1.536 MS/s stream channelized by
a single WOLA polyphase filterbank pass (all VFOs at once), then B
vmapped feedforward MSK demods to soft bits.  That is the entire
aero-publish + aero-decode compute path per VFO.  The reference's per-VFO
tree shape (NCO mix -> 6-stage halfband cascade -> Hilbert USB demod ->
demod) is benchmarked alongside for comparison (stderr).

``vs_baseline``: the reference needs one CPU process per VFO at ~1x real
time and one SDR per 1.536 MS/s stream (SURVEY.md §6).  We report how many
complete 1.536 MS/s stations (wideband + B-VFO bank) one device sustains
by this device-only measure.

Every output names the machine: the card's name and power limit as
nvidia-smi gives them, and JAX's device kind and count.  The run refuses
a device that is not a GPU, and a benchmark that fails makes the run exit
non-zero.

Timing: each benchmark repeats its timed batch; ``best`` is the least
time, ``median`` and ``spread`` show the run-to-run swing.
"""

import json
import sys
import time

import numpy as np


_PENDING = []


def _measure(run_batch, work_per_batch, repeats=7):
    """Register a warmed, timed batch; repeats run LATER via
    ``_run_rounds`` and fill the returned dict in place.

    ``best`` is the least time; ``median`` and ``spread`` quantify the
    run-to-run swing: spread = (worst-best)/median.
    """
    m = {"best": 0.0, "median": 0.0, "spread_pct": 0.0}
    _PENDING.append((run_batch, work_per_batch, repeats, m))
    return m


def _run_rounds():
    """Round-robin the registered batches: one repeat of EACH metric per
    round (A,B,C,...,A,B,C,... instead of A*7,B*7,...), so a transient
    stall degrades every metric slightly instead of wiping one metric's
    entire repeat set."""
    if not _PENDING:
        return
    times = [[] for _ in _PENDING]
    rounds = max(r for _, _, r, _ in _PENDING)
    for rd in range(rounds):
        for i, (batch, _, reps, _) in enumerate(_PENDING):
            if rd < reps:
                times[i].append(batch())
    for i, (_, work, _, m) in enumerate(_PENDING):
        ts = sorted(times[i])
        med = ts[len(ts) // 2]
        m.update(best=work / ts[0], median=work / med,
                 spread_pct=100.0 * (ts[-1] - ts[0]) / med)
    _PENDING.clear()


def _fmt(m, scale=1e6):
    return (f"{m['best']/scale:.1f} best / {m['median']/scale:.1f} median "
            f"(spread {m['spread_pct']:.0f}%)")


def bench_full_chain(B=50, n_iter=10):
    import jax
    import jax.numpy as jnp
    from aero_tpu.ops import HALFBAND_TAPS, hilbert_design
    from aero_tpu.ops.nco import nco_mix
    from aero_tpu.ops.fir import (fir_decimate_init, fir_decimate_apply,
                                  fir_init, fir_apply, delay_init, delay_apply)
    from aero_tpu.models.msk import make_config, msk_init, msk_step, msk_modulate

    fs_wb = 1536000.0
    fs = 24000.0
    stages = 6                                  # 1536000 / 2^6 = 24000
    cfg = make_config(fs, 1200.0)
    L_wb = cfg.block_len * (2 ** stages)        # 1,024,000 samples (0.67 s)

    hb = HALFBAND_TAPS[11].astype(np.float32)
    hilb = hilbert_design(125).astype(np.float32)

    from aero_tpu.ops.compat import tree_pack, tree_unpack

    def chain_init(_):
        return {
            "nco": jnp.asarray(0.0, jnp.float32),
            "hb": [fir_decimate_init(11, dtype=jnp.complex64)
                   for _ in range(stages)],
            "hilb": fir_init(125),
            "dly": delay_init(62),
            "demod": msk_init(cfg),
        }

    def chain_step(stp, wideband2, f):
        st = tree_unpack(stp)
        new = dict(st)
        wideband = (wideband2[0] + 1j * wideband2[1]).astype(jnp.complex64)
        new["nco"], z = nco_mix(st["nco"], wideband, f)
        hbs = []
        for s in st["hb"]:
            s, z = fir_decimate_apply(s, z, jnp.asarray(hb), 2)
            hbs.append(s)
        new["hb"] = hbs
        new["hilb"], h = fir_apply(st["hilb"], z.imag, jnp.asarray(hilb))
        new["dly"], d = delay_apply(st["dly"], z.real)
        audio = (d - h) * 10.0
        new["demod"], out = msk_step(st["demod"], audio, cfg)
        return tree_pack(new), out["soft_bits"]

    states = jax.jit(lambda: jax.vmap(
        lambda _: tree_pack(chain_init(0)))(jnp.arange(B)))()
    freqs = jnp.asarray(np.linspace(-0.4, 0.4, B, dtype=np.float32))

    # wideband test signal: a complex exponential keeps every demod branch
    # active without mattering for throughput; passed as a float32 [2, T]
    # pair (ops/compat.py)
    n = np.arange(L_wb)
    wb = (0.1 * np.exp(2j * np.pi * 0.01 * n)).astype(np.complex64)
    wideband = jnp.asarray(np.stack([wb.real, wb.imag]))

    @jax.jit
    def step(states, wideband, freqs):
        return jax.vmap(chain_step, in_axes=(0, None, 0))(states, wideband,
                                                          freqs)

    states, out = step(states, wideband, freqs)
    jax.block_until_ready(out)

    def batch():
        nonlocal states
        t0 = time.perf_counter()
        for _ in range(n_iter):
            states, out = step(states, wideband, freqs)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    m = _measure(batch, n_iter * L_wb)
    return m, B


def bench_full_chain_pfb(B=50, n_iter=10):
    """Same full chain, filterbank shape: one WOLA polyphase filterbank
    pass channelizes the whole 1.536 MS/s band (all VFOs at once,
    channelizer/pfb.py), then a vmapped feedforward MSK demod per VFO.
    This is the architecture SURVEY.md §7.4 calls for; the per-VFO
    cascade bench above mirrors the reference's tree for comparison."""
    import jax
    import jax.numpy as jnp
    from aero_tpu.channelizer.pfb import pfb_channelize_fused, pfb_init
    from aero_tpu.models.msk import make_config, msk_init, msk_step

    fs_wb = 1536000.0
    out_rate = 24000.0
    K = int(2 * fs_wb / out_rate)               # 128 bins, 2x oversampled
    M = K // 2
    cfg = make_config(out_rate, 1200.0)
    L_wb = cfg.block_len * M

    bins = np.linspace(2, K - 2, B).round().astype(np.int32)
    resid = np.linspace(-0.04, 0.04, B).astype(np.float32)  # cycles/sample

    from aero_tpu.ops.compat import tree_pack, tree_unpack

    def init(_):
        # packed at the boundary (ops/compat.py)
        return tree_pack({
            "pfb": pfb_init(K),
            "phase": jnp.zeros((B,), jnp.float32),
            "demod": jax.vmap(lambda _: msk_init(cfg))(jnp.arange(B))})

    def step(stp, wideband2):
        st = tree_unpack(stp)
        new = dict(st)
        wideband = (wideband2[0] + 1j * wideband2[1]).astype(jnp.complex64)
        new["pfb"], z = pfb_channelize_fused(st["pfb"], wideband, K)
        zb = z[jnp.asarray(bins)]                                # [B, F]
        F = zb.shape[1]
        n = jnp.arange(F, dtype=jnp.float32)
        ramp = st["phase"][:, None] + jnp.asarray(resid)[:, None] * n
        osc = jnp.exp(2j * jnp.pi * jnp.mod(ramp, 1.0)).astype(jnp.complex64)
        new["phase"] = jnp.mod(st["phase"] + jnp.asarray(resid) * F, 1.0)
        audio = (zb * osc).real * 10.0
        new["demod"], out = jax.vmap(lambda s, x: msk_step(s, x, cfg))(
            st["demod"], audio)
        return tree_pack(new), out["soft_bits"]

    state = jax.jit(init)(0)
    n = np.arange(L_wb)
    wb = (0.1 * np.exp(2j * np.pi * 0.01 * n)).astype(np.complex64)
    wideband = jnp.asarray(np.stack([wb.real, wb.imag]))
    step_j = jax.jit(step)
    state, out = step_j(state, wideband)
    jax.block_until_ready(out)

    def batch():
        nonlocal state
        t0 = time.perf_counter()
        for _ in range(n_iter):
            state, out = step_j(state, wideband)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    m = _measure(batch, n_iter * L_wb)
    return m, B


def bench_oqpsk_demod(B=64, n_iter=60):
    """OQPSK 10500 (C-band P channel) vmapped demod bank."""
    import jax
    import jax.numpy as jnp
    from aero_tpu.models.oqpsk import make_config, oqpsk_init, oqpsk_step
    from aero_tpu.ops.compat import tree_pack, tree_unpack
    cfg = make_config(48000.0, 10500.0)
    rng = np.random.default_rng(0)
    samples = jnp.asarray(
        rng.standard_normal((B, cfg.block_len)).astype(np.float32))
    states = jax.jit(lambda: jax.vmap(
        lambda _: tree_pack(oqpsk_init(cfg)))(jnp.arange(B)))()

    def one_fn(p, x):
        s2, out = oqpsk_step(tree_unpack(p), x, cfg)
        return tree_pack(s2), out

    # donate the state carry like the production VfoBank does
    step = jax.jit(lambda s, x: jax.vmap(one_fn)(s, x), donate_argnums=(0,))

    states, out = step(states, samples)
    jax.block_until_ready(out)

    def batch():
        nonlocal states
        t0 = time.perf_counter()
        for _ in range(n_iter):
            states, out = step(states, samples)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    return _measure(batch, n_iter * B * cfg.block_len)


def bench_burst_window(B=64, n_iter=60):
    """Burst MSK window demod (R/T channels): B candidate windows at once
    (the 'decode all burst hypotheses in a batch' shape, SURVEY.md §7)."""
    import jax
    import jax.numpy as jnp
    from aero_tpu.models.burst_msk import make_config, burst_msk_window
    cfg = make_config(24000.0, 1200.0)
    rng = np.random.default_rng(0)
    samples = jnp.asarray(
        rng.standard_normal((B, cfg.window_len)).astype(np.float32))
    gate = jnp.ones((B, cfg.window_len), jnp.float32)

    @jax.jit
    def step(samples, gate):
        return jax.vmap(lambda x, g: burst_msk_window(x, g, cfg))(samples,
                                                                  gate)

    out = step(samples, gate)
    jax.block_until_ready(out)

    def batch():
        t0 = time.perf_counter()
        for _ in range(n_iter):
            out = step(samples, gate)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    return _measure(batch, n_iter * B * cfg.window_len)


def bench_fused_station(B=50, n_iter=16, ingest="int4", blocks_per_step=8):
    """END-TO-END: quantized ingest -> device chain -> host framers,
    via the served FusedStation (runtime/fused_station.py).  Reported as
    x real time, in throughput mode (multi-block dispatch, one fetch round
    trip per 8 blocks)."""
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime.fused_station import FusedStation
    vfos = "".join(
        f"{i+1}\\frequency={1545002000 + i*19000}\n{i+1}\\data_rate=1200\n"
        f"{i+1}\\topic=V{i}\n{i+1}\\gain=100\n" for i in range(B))
    ini = (f"[General]\nsample_rate=1536000\ncenter_frequency=1545000000\n"
           f"[vfos]\nsize={B}\n{vfos}")
    cfg = load_ini(ini, is_text=True)
    st = FusedStation(cfg, ingest_dtype=ingest,
                      blocks_per_step=blocks_per_step)
    rng = np.random.default_rng(0)
    blk = st.quantize((0.02 * (rng.standard_normal((st.block_len, 2))
                               @ [1, 1j])).astype(np.complex64))
    for _ in range(2 * blocks_per_step):
        st.process(blk)
    st.flush()
    rates = []
    for _ in range(5):
        st.stats.wideband_samples = 0
        st.stats.wall_seconds = 0.0
        for _ in range(n_iter):
            st.process(blk)
        st.flush()
        rates.append(st.stats.realtime_factor)
    rates.sort()
    m = {"best": rates[-1], "median": rates[len(rates) // 2],
         "spread_pct": 100.0 * (rates[-1] - rates[0])
         / max(rates[len(rates) // 2], 1e-9)}
    return {k: (v / 1536000.0 if k != "spread_pct" else v)
            for k, v in m.items()}, B


def bench_fused_station_latency(B=50, n_msgs=24):
    """END-TO-END LATENCY: wideband-sample arrival -> ACARS emit, real-time
    paced (VERDICT r4 item 6).  A real receiver has a latency budget, not
    just a throughput one, and the fused station's multi-block dispatch
    trades exactly that: blocks_per_step=8/pipeline_depth=2 (the
    throughput shape the RT-factor bench uses) holds results for up to
    8 x 667 ms of batch fill plus two in-flight batches, while
    blocks_per_step=1/pipeline_depth=0 drains every block.

    Method: a 50-VFO production config with one VFO carrying back-to-back
    single-message P frames.  A mapping pass (blocks_per_step=1, depth=0,
    unpaced) records for each message the block index whose processing
    emitted it — i.e. the block holding the last soft bit the deframer
    needed.  The timed passes then feed blocks at the real-time rate
    (arrival time of block i = (i+1) x block_len/fs) and report
    the median and the max of emit_time - arrival_time(needed block) over
    the messages (with 24 of them, no higher percentile is measurable).
    """
    from scipy.signal import resample_poly
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime.fused_station import FusedStation
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol.framing import build_p_frames
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu

    vfos = "".join(
        f"{i+1}\\frequency={1545002000 + i*19000}\n{i+1}\\data_rate=1200\n"
        f"{i+1}\\topic=V{i}\n{i+1}\\gain=100\n" for i in range(B))
    ini = (f"[General]\nsample_rate=1536000\ncenter_frequency=1545000000\n"
           f"[vfos]\nsize={B}\n{vfos}")
    cfg = load_ini(ini, is_text=True)

    # one ACARS message per P frame: pad each message's SUs to the 6-SU
    # infofield with fills so message k lives in exactly one frame
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    fields = []
    for k in range(n_msgs):
        ud = make_acars_userdata("2", "VH-LAT", "!", "AA", "M",
                                 f"LATENCY {k:04d}")
        sus = [append_crc16_bytes(b)
               for b in segment_isu(ud, 0x654321, 0x41)]
        assert len(sus) <= 6
        sus += [fill] * (6 - len(sus))
        fields.append(b"".join(sus))
    bits = build_p_frames(fields, 1200, lead_frames=6)
    audio = np.asarray(msk_modulate(bits, 24000, 1200, freq=1000.0))
    bb = resample_poly(audio.astype(np.float64), 64, 1).astype(np.float32)
    delta = (1545002000 + 1 * 19000) - 1545000000
    t = np.arange(len(bb)) / 1536000.0
    wide = (bb * np.exp(2j * np.pi * delta * t)).astype(np.complex64)

    st0 = FusedStation(cfg, blocks_per_step=1, pipeline_depth=0)
    blk_len = st0.block_len
    wide = np.concatenate(
        [wide, np.zeros((-len(wide)) % blk_len + 2 * blk_len,
                        np.complex64)])
    blocks = [wide[i:i + blk_len] for i in range(0, len(wide), blk_len)]
    block_dur = blk_len / 1536000.0

    def msg_index(item):
        return int(item.message.split()[-1])

    # ---- mapping pass: block index whose processing emits message k ----
    need_block = {}
    cur = [0]
    st0.on_acars = lambda v, it: need_block.setdefault(msg_index(it),
                                                       cur[0])
    for i, b in enumerate(blocks):
        cur[0] = i
        st0.process(b)
    st0.flush()
    if len(need_block) < max(2, n_msgs // 2):
        raise RuntimeError(f"latency mapping decoded only "
                           f"{len(need_block)}/{n_msgs} messages")

    def paced_pass(blocks_per_step, pipeline_depth):
        lats = {}
        st = FusedStation(cfg, blocks_per_step=blocks_per_step,
                          pipeline_depth=pipeline_depth)
        arrive = {}

        def on_acars(v, it):
            k = msg_index(it)
            if k in need_block and k not in lats:
                lats[k] = time.perf_counter() - arrive[need_block[k]]

        st.on_acars = on_acars
        # warm EVERY step shape the paced loop will use outside the
        # timed region: the full blocks_per_step batch AND the flush
        # remainder (FusedStation jits one program per batch size m, so
        # an unwarmed shape would compile inside the real-time-paced
        # loop and the published latency would measure compile time)
        for _ in range(blocks_per_step):
            st.process(np.zeros(blk_len, np.complex64))
        st.flush()
        rem = len(blocks) % blocks_per_step
        if rem:
            for _ in range(rem):
                st.process(np.zeros(blk_len, np.complex64))
            st.flush()
        t_start = time.perf_counter()
        for i, b in enumerate(blocks):
            target = t_start + (i + 1) * block_dur   # block fully arrived
            now = time.perf_counter()
            if now < target:
                time.sleep(target - now)
            arrive[i] = max(now, target)
            st.process(b)
        st.flush()
        v = sorted(1e3 * x for x in lats.values())
        if not v:
            raise RuntimeError("latency pass decoded nothing")
        return v[len(v) // 2], v[-1]

    p50_tp, max_tp = paced_pass(8, 2)     # throughput shape (RT bench)
    p50_lat, max_lat = paced_pass(1, 0)   # latency shape
    return {"bps8": (p50_tp, max_tp), "bps1": (p50_lat, max_lat),
            "n": len(need_block)}


def bench_demod_only(B=128, n_iter=60):
    import jax
    import jax.numpy as jnp
    from aero_tpu.models.msk import make_config, msk_init, msk_step, msk_modulate
    from aero_tpu.ops.compat import tree_pack, tree_unpack
    cfg = make_config(24000.0, 1200.0)
    rng = np.random.default_rng(0)
    one = msk_modulate(rng.integers(0, 2, 4000).astype(np.uint8), 24000.0,
                       1200.0)[: cfg.block_len]
    samples = jnp.asarray(np.tile(one, (B, 1)), jnp.float32)
    states = jax.jit(lambda: jax.vmap(
        lambda _: tree_pack(msk_init(cfg)))(jnp.arange(B)))()

    @jax.jit
    def step(states, samples):
        def one_fn(p, x):
            s2, out = msk_step(tree_unpack(p), x, cfg)
            return tree_pack(s2), out
        return jax.vmap(one_fn)(states, samples)

    states, out = step(states, samples)
    jax.block_until_ready(out)

    def batch():
        nonlocal states
        t0 = time.perf_counter()
        for _ in range(n_iter):
            states, out = step(states, samples)
        jax.block_until_ready(out)
        return time.perf_counter() - t0

    return _measure(batch, n_iter * B * cfg.block_len)


def machine():
    """The card (nvidia-smi name and power limit) and JAX's devices;
    refuses anything but a GPU."""
    import subprocess
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's first device is "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"card": card, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def main():
    full = "--quick" not in sys.argv
    FS_WB = 1536000.0
    mach = machine()
    print(f"machine: {mach['card']}; JAX {mach['device_kind']} x "
          f"{mach['device_count']}", file=sys.stderr)
    extras = {}

    chain, B = bench_full_chain_pfb()
    casc_r = demod = oq = bw = None
    if full:
        casc_r = bench_full_chain()
        demod = bench_demod_only()
        oq = bench_oqpsk_demod()
        bw = bench_burst_window()

    # all metrics repeat round-robin so a stall cannot wipe one
    _run_rounds()

    stations = chain["best"] / FS_WB
    print(f"pfb_full_chain: {_fmt(chain)} MS/s wideband, {stations:.1f} "
          f"stations x {B} VFOs per device", file=sys.stderr)
    if casc_r:
        casc, _ = casc_r
        print(f"cascade_full_chain: {_fmt(casc)} MS/s wideband, "
              f"{casc['best'] / FS_WB:.1f} stations (reference-shaped "
              f"tree)", file=sys.stderr)
        extras["cascade_best_msps"] = round(casc["best"] / 1e6, 1)
    if demod:
        print(f"demod_only: {_fmt(demod)} MS/s audio", file=sys.stderr)
        extras["demod_best_msps"] = round(demod["best"] / 1e6, 1)
    if oq:
        print(f"oqpsk_demod: {_fmt(oq)} MS/s audio (10500 bps C-band)",
              file=sys.stderr)
        extras["oqpsk_best_msps"] = round(oq["best"] / 1e6, 1)
    if bw:
        print(f"burst_window: {_fmt(bw)} MS/s audio (batched R/T "
              f"candidate windows)", file=sys.stderr)
        extras["burst_best_msps"] = round(bw["best"] / 1e6, 1)

    if full:
        rtf, B2 = bench_fused_station()
        print(f"fused_station: {rtf['best']:.1f}x best / "
              f"{rtf['median']:.1f}x median real time END TO END "
              f"({B2} VFOs, int4 ingest, incl. host framing)",
              file=sys.stderr)
        extras["fused_station_rt_best"] = round(rtf["best"], 1)
        rtf2, _ = bench_fused_station(ingest="int2")
        print(f"fused_station_int2: {rtf2['best']:.1f}x best / "
              f"{rtf2['median']:.1f}x median real time END TO END "
              f"(2-bit sign-magnitude ingest)", file=sys.stderr)
        extras["fused_station_int2_rt_best"] = round(rtf2["best"], 1)
        lat = bench_fused_station_latency()
        (p50_tp, max_tp), (p50_lo, max_lo) = lat["bps8"], lat["bps1"]
        print(f"fused_station_latency: p50 {p50_tp:.0f} ms / max "
              f"{max_tp:.0f} ms ingest->ACARS at blocks_per_step=8 "
              f"depth=2 (throughput shape); p50 {p50_lo:.0f} ms / max "
              f"{max_lo:.0f} ms at blocks_per_step=1 depth=0 (latency "
              f"shape; {lat['n']} msgs, real-time paced, 50 VFOs)",
              file=sys.stderr)
        extras["latency_bps8_p50_ms"] = round(p50_tp, 1)
        extras["latency_bps8_max_ms"] = round(max_tp, 1)
        extras["latency_bps1_p50_ms"] = round(p50_lo, 1)
        extras["latency_bps1_max_ms"] = round(max_lo, 1)

    print(json.dumps({
        "metric": "full_chain_wideband_throughput",
        "value": round(chain["best"] / 1e6, 2),
        "unit": "MSamples/s/device",
        "vs_baseline": round(stations, 1),
        "median": round(chain["median"] / 1e6, 2),
        "spread_pct": round(chain["spread_pct"], 1),
        **mach,
        **extras,
    }))


if __name__ == "__main__":
    main()
