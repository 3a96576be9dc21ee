#!/usr/bin/env python3
"""Smoke test of the served path on one NVIDIA GPU.

Drives the station through its own entry point at the size of the repo's
flagship deployment -- the 26 sub VFOs of configs/aor_w_54_lband.ini at
1.536 MS/s (3 x 600 and 21 x 1200 bps P channels, 2 x 1200 bps R-burst
watchers; the INI's main VFO is left out, FusedStation serves sub-VFO
banks) -- and checks every decode against what a seeded generator
injected.

Phases, in order; the first that fails ends the run (traceback, exit 1):
  a  device: JAX's first device is a GPU; the native Viterbi and ingest
     libraries build from their sources and load
  b  served path: station_main, in this process, on ~23 s of generated
     IQ with the default int16 ingest
  c  the same IQ with --ingest-dtype int4 --batch-framing
  d  every channel type: the five-path mixed layout through FusedStation
  e  plain reference: station_main --platform cpu in a subprocess (so
     only this process opens the GPU), then the device step at default
     and at highest matmul precision against the CPU in float32
  f  Viterbi timings: the batch decoder on the GPU, the native decoder
     on the host

Prints the card's name and power limit first, one JSON "info" line per
result, and as its last line
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

Usage:
    python chip_smoke.py                # one GPU, phases a-f
    python chip_smoke.py --four-cards   # FusedStation.shard over four GPUs
                                        # against one GPU, and nothing else
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SMOKE_DIR = os.path.join(ROOT, ".smoke")
BANK_INI = os.path.join(ROOT, "configs", "aor_w_54_lband.ini")

# -- the 54W bank's traffic ---------------------------------------------
# Every P channel carries ACARS from the first block on, as a ground
# station's P channels do; each R watcher gets bursts.
MSGS_PER_CHANNEL = 3
BANK_BLOCKS = 17            # FusedStation blocks of 2,048,000 samples
AUDIO_HZ = 1000.0           # P carriers sit 1 kHz above their VFO
LEAD_FRAMES = {600: 3, 1200: 4}   # frames before the first message
# the 1200 bps burst demod acquires within ~4-9 kHz of audio (its search
# is centered at fs/4 = 6 kHz); the two R watchers lie 5 kHz apart, so a
# burst at 6 kHz shows at 1 kHz or 11 kHz in the other watcher's audio,
# outside that range: each burst is decoded by its own watcher only
BURST_AUDIO_HZ = 6000.0
AMPLITUDE = 0.1             # per carrier; fits int4 ingest (levels of 1/7)
NOISE = 0.01                # per arm
AES_BASE = 0x540100

# -- tolerances -----------------------------------------------------------
# Share of soft bits whose hard decision (soft >= 128) must match the CPU
# float32 run, per carrying VFO over the blocks where the CPU run reports
# a signal.  Soft bits far from 128 cannot flip under TF32's ~3 digits;
# this bounds how many may sit close enough to the threshold to do so.
HARD_BIT_AGREEMENT = 0.999
# four-card telemetry against one card: same program per VFO row, so
# only reduction order differs
FOUR_CARD_FREQ_TOL_HZ = 1.0
FOUR_CARD_MSE_TOL = 1e-3


def info(name: str, **values) -> None:
    print(json.dumps({"info": name, **values}), flush=True)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def require_gpu(devices, count: int = 1):
    """The devices JAX found, refused unless they are ``count`` GPUs."""
    if not devices or devices[0].platform != "gpu":
        kind = f"{devices[0].platform} ({devices[0].device_kind})" \
            if devices else "nothing"
        raise RuntimeError(f"no GPU: JAX's first device is {kind}")
    if len(devices) < count:
        raise RuntimeError(f"need {count} GPUs, JAX found {len(devices)}")
    return devices[:count]


def compare_decoded(got: Counter, want: Counter, what: str) -> None:
    """Decoded (topic, message) multiset must equal the injected one."""
    missing = want - got
    extra = got - want
    if missing or extra:
        raise AssertionError(
            f"{what}: decoded set differs from the injected set; missing "
            f"{sorted(missing.elements())}, extra {sorted(extra.elements())}")


def best_of(fn, n: int = 5) -> float:
    """Least wall time of n calls of fn (each ends in block_until_ready)."""
    fn()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times)


# -- traffic generators ---------------------------------------------------

def bank_ini_text() -> str:
    """configs/aor_w_54_lband.ini without its [main_vfos] section."""
    keep, out = True, []
    with open(BANK_INI) as f:
        for line in f:
            if line.strip().startswith("["):
                keep = line.strip() != "[main_vfos]"
            if keep:
                out.append(line)
    return "".join(out)


def bank_carriers(cfg) -> list:
    """The bank's continuous (P channel) VFOs."""
    return [s.topic for s in cfg.subs if not s.burst]


def bank_traffic(cfg, block_len: int, seed: int = 54):
    """Seeded wideband IQ for the 54W bank and what it carries.

    Returns (iq, want, aes_topic): ``want`` counts the injected (topic,
    message) pairs; ``aes_topic`` maps each AES address to the VFO it
    transmits on, so output without a topic (station_main's jsondump)
    can be scored too."""
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu.protocol.rt_framing import build_t_burst
    from aero_tpu.synth import msk_wideband, p_frame_bits

    fs = cfg.sample_rate
    n = BANK_BLOCKS * block_len
    rng = np.random.default_rng(seed)
    iq = (rng.normal(0, NOISE, n)
          + 1j * rng.normal(0, NOISE, n)).astype(np.complex64)
    subs = {s.topic: s for s in cfg.subs}
    want, aes_topic = Counter(), {}

    def add(sig, t0_s):
        t0 = int(t0_s * fs)
        assert t0 + len(sig) <= n, "traffic runs past the end of the IQ"
        iq[t0: t0 + len(sig)] += sig

    for k, topic in enumerate(bank_carriers(cfg)):
        s = subs[topic]
        aes = AES_BASE + k
        aes_topic[aes] = topic
        msgs = [(aes, f"N54S{k:02d}", f"{topic} MSG {j}")
                for j in range(MSGS_PER_CHANNEL)]
        bits = p_frame_bits(msgs, s.data_rate,
                            lead_frames=LEAD_FRAMES[s.data_rate],
                            tail_frames=1)
        add(msk_wideband(bits, fs, s.data_rate,
                         s.freq - cfg.center_frequency + AUDIO_HZ,
                         AMPLITUDE, rng.uniform(0, 2 * np.pi)),
            rng.uniform(0.0, 0.3))
        want.update((topic, text) for _, _, text in msgs)

    for k, topic in enumerate(s.topic for s in cfg.subs if s.burst):
        s = subs[topic]
        aes = AES_BASE + 0x80 + k
        aes_topic[aes] = topic
        for j in range(MSGS_PER_CHANNEL):
            text = f"{topic} BURST {j}"
            sus = segment_isu(make_acars_userdata(
                "2", f"N54R{k:02d}", "!", "H1", "A", text), aes, 0x41)
            bits = build_t_burst(aes, 0x41, sus, preamble_bits=96)
            add(msk_wideband(bits, fs, s.data_rate,
                             s.freq - cfg.center_frequency + BURST_AUDIO_HZ,
                             AMPLITUDE, rng.uniform(0, 2 * np.pi)),
                1.5 + 3.0 * k + 6.0 * j)
            want[(topic, text)] += 1
    return iq, want, aes_topic


def four_card_traffic(cfg, block_len: int, blocks: int = 8, seed: int = 4):
    """The five-path layout at 1.536 MS/s with ACARS on V0, Q0, S0 and the
    burst watcher B0, and C-channel voice on C0.  Returns (iq, want,
    voices) with voices the C0 frames sent."""
    from scipy.signal import resample_poly
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.models.oqpsk import oqpsk_modulate
    from aero_tpu.protocol.c_framing import build_c_frames
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu.protocol.rt_framing import build_t_burst
    from aero_tpu.synth import p_stream

    fs = cfg.sample_rate
    n = blocks * block_len
    rng = np.random.default_rng(seed)
    subs = {s.topic: s for s in cfg.subs}
    iq = (rng.normal(0, 0.003, n)
          + 1j * rng.normal(0, 0.003, n)).astype(np.complex64)

    def add(audio, fs_audio, topic, t0_s=0.0):
        bb = resample_poly(np.asarray(audio, np.float64), fs // fs_audio, 1)
        delta = subs[topic].freq - cfg.center_frequency
        t0 = int(t0_s * fs)
        m = min(len(bb), n - t0)
        ph = 2 * np.pi * delta / fs * np.arange(t0, t0 + m)
        iq[t0: t0 + m] += (bb[:m] * np.exp(1j * ph)).astype(np.complex64)

    cframes = []
    for _ in range(2):
        csus = [append_crc16_bytes(bytes([0x30]) + bytes(
            rng.integers(0, 256, 9, dtype=np.uint8).tolist()))
            for _ in range(3)]
        cframes.append((csus, bytes(rng.integers(0, 256, 300,
                                                 dtype=np.uint8).tolist())))
    add(msk_modulate(p_stream(1200, "FOUR 1200", 3), 24000, 1200.0,
                     freq=1000.0), 24000, "V0")
    add(oqpsk_modulate(p_stream(10500, "FOUR 10500", 6), 48000, 10500.0,
                       freq=8000.0), 48000, "Q0")
    add(msk_modulate(p_stream(600, "FOUR 600", 2), 12000, 600.0,
                     freq=1000.0), 12000, "S0")
    add(oqpsk_modulate(build_c_frames(cframes, lead_frames=3), 48000, 8400,
                       freq=8000.0), 48000, "C0")
    bsus = segment_isu(make_acars_userdata("2", "NFOUR", "!", "H1", "A",
                                           "FOUR BURST"), 0x444444, 0x41)
    add(msk_modulate(build_t_burst(0x444444, 0x41, bsus, preamble_bits=96),
                     12000, 600.0, freq=3000.0) * 1.6, 12000, "B0", 2.0)
    want = Counter({("V0", "FOUR 1200"): 1, ("Q0", "FOUR 10500"): 1,
                    ("S0", "FOUR 600"): 1, ("B0", "FOUR BURST"): 1})
    return iq, want, [v for _, v in cframes]


# -- running the station --------------------------------------------------

def blocks_of(iq, block_len: int):
    return [iq[i: i + block_len]
            for i in range(0, len(iq) - block_len + 1, block_len)]


def block_len_of(cfg) -> int:
    from aero_tpu.runtime.fused_station import FusedStation
    return FusedStation(cfg).block_len


def run_fused(cfg, blocks, mesh=None, **kw):
    """FusedStation over ``blocks``; returns (station, decoded, voices,
    rows) with rows the device's packed output buffer of every block."""
    from aero_tpu.runtime.fused_station import FusedStation

    class Tap(FusedStation):
        def _drain(self, packed):
            self.rows.extend(np.asarray(packed))
            super()._drain(packed)

    got, voices = Counter(), []
    st = Tap(cfg, on_acars=lambda t, item: got.update([(t, item.message)]),
             on_voice=lambda t, data, hx: voices.append((t, data)), **kw)
    st.rows = []
    if mesh is not None:
        st.shard(mesh)
    for b in blocks:
        st.process(b)
    st.flush()
    return st, got, voices, np.stack(st.rows)


def check_voice(voices, topic, sent, what: str) -> None:
    """Every voice frame comes from ``topic``, and the frames sent arrive
    there in order, one after the other (the C channel's lead-in and
    run-out frames carry voice too, so more frames arrive than were
    sent)."""
    others = {t for t, _ in voices} - {topic}
    got = [v for t, v in voices if t == topic]
    if others or not any(got[i: i + len(sent)] == sent
                         for i in range(len(got))):
        raise AssertionError(f"{what}: voice frames on {sorted(others)} or "
                             f"the {len(sent)} sent missing from {topic}")


def decoded_from_jsondump(lines, aes_topic) -> Counter:
    got = Counter()
    for line in lines:
        if not line.startswith("{"):
            continue
        isu = json.loads(line)["isu"]
        aes = next(e["addr"] for e in (isu["src"], isu["dst"])
                   if e["type"] == "Aircraft Earth Station")
        a = isu["acars"]
        text = (a.get("msg_num", "") + a.get("msg_num_seq", "")
                + a.get("flight", "") + a.get("msg_text", ""))
        got[(aes_topic.get(int(aes, 16), f"AES {aes}"), text)] += 1
    return got


def station_main_in_process(argv, aes_topic):
    """station_main.main(argv) in this process; returns (decoded,
    final_stats, device line)."""
    from aero_tpu.runtime import station_main
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = station_main.main(argv)
    if rc != 0:
        raise RuntimeError(f"station_main exited {rc}: {err.getvalue()}")
    jl = [json.loads(ln) for ln in err.getvalue().splitlines()
          if ln.startswith("{")]
    final = next(d["final_stats"] for d in jl if "final_stats" in d)
    device = next(d["device"] for d in jl if "device" in d)
    return (decoded_from_jsondump(out.getvalue().splitlines(), aes_topic),
            final, device)


def station_argv(ini_path, iq_path, *extra):
    return ["-c", ini_path, "--iq-file", iq_path, "-s", "SMOKE",
            "--format", "jsondump", "--stats-every", "1e9", *extra]


# -- phases ---------------------------------------------------------------

def phase_device():
    import jax
    from aero_tpu import native
    from aero_tpu.utils.profiling import enable_compile_cache
    cache = enable_compile_cache()
    dev = require_gpu(jax.devices())[0]
    if not (native.have_native() and native.have_native_ingest()):
        raise RuntimeError("native Viterbi/ingest libraries did not build")
    info("device", jax=jax.__version__, platform=dev.platform,
         kind=dev.device_kind, count=len(jax.devices()),
         xla_flags=os.environ.get("XLA_FLAGS", ""), compile_cache=cache)
    return dev


def prepare_bank():
    """Writes the bank INI and IQ under .smoke/; returns the paths, the
    parsed config, the block length and the traffic."""
    from aero_tpu.channelizer import load_ini
    os.makedirs(SMOKE_DIR, exist_ok=True)
    ini_path = os.path.join(SMOKE_DIR, "aor_w_54_lband_subs.ini")
    with open(ini_path, "w") as f:
        f.write(bank_ini_text())
    cfg = load_ini(ini_path)
    block_len = block_len_of(cfg)
    t0 = time.perf_counter()
    iq, want, aes_topic = bank_traffic(cfg, block_len)
    iq_path = os.path.join(SMOKE_DIR, "aor_w_54_lband.cf32")
    iq.tofile(iq_path)
    info("bank_traffic", vfos=len(cfg.subs),
         seconds=len(iq) / cfg.sample_rate, messages=sum(want.values()),
         carrying_vfos=len({t for t, _ in want}),
         generate_s=time.perf_counter() - t0)
    return ini_path, iq_path, cfg, block_len, iq, want, aes_topic


def phase_served(name, ini_path, iq_path, seconds, want, aes_topic, *extra):
    got, final, device = station_main_in_process(
        station_argv(ini_path, iq_path, *extra), aes_topic)
    if device["platform"] != "gpu":
        raise RuntimeError(f"station_main ran on {device}")
    compare_decoded(got, want, name)
    wall, first = final["wall_s"], final["first_block_s"]
    info(name, options=list(extra), decoded=sum(got.values()),
         wall_s=wall, first_block_s=first, iq_seconds=seconds,
         realtime_factor=seconds / wall,
         realtime_factor_after_first_block=(
             seconds * (BANK_BLOCKS - 1) / BANK_BLOCKS / (wall - first)))


def phase_mixed():
    from aero_tpu.channelizer import load_ini
    from aero_tpu.synth import MIXED_ACARS, mixed_ini, mixed_wideband
    cfg = load_ini(mixed_ini(), is_text=True)
    wb, cframes = mixed_wideband()
    t0 = time.perf_counter()
    block_len = block_len_of(cfg)
    w = np.concatenate([wb, np.zeros(2 * block_len, np.complex64)])
    _, got, voices, _ = run_fused(cfg, blocks_of(w, block_len),
                                  ingest_dtype="int16")
    compare_decoded(got, Counter(MIXED_ACARS), "mixed")
    check_voice(voices, "C8400", [v for _, v in cframes], "mixed")
    info("mixed", acars=sorted(got), voice_frames=len(voices),
         wall_s=time.perf_counter() - t0)


def phase_reference(ini_path, iq_path, want, aes_topic):
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "aero_tpu.runtime.station_main",
         *station_argv(ini_path, iq_path, "--platform", "cpu")],
        capture_output=True, text=True, timeout=900, cwd=ROOT,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    if out.returncode != 0:
        raise RuntimeError(f"CPU station_main exited {out.returncode}: "
                           f"{out.stderr[-3000:]}")
    got = decoded_from_jsondump(out.stdout.splitlines(), aes_topic)
    compare_decoded(got, want, "cpu_reference")
    info("cpu_reference", decoded=sum(got.values()),
         wall_s=time.perf_counter() - t0)


def vfo_columns(st, topic):
    """(soft-bit slice, telemetry index of slot 0, rows per slot) of one
    continuous VFO inside the station's packed output row."""
    for key in st._order:
        if topic in st.topics[key]:
            r = st.topics[key].index(topic)
            pos, per = st._soft_ofs[key]
            nb = len(st.groups[key])
            return (slice(pos + r * per, pos + (r + 1) * per),
                    st._tel_ofs[key] + r, nb)
    raise KeyError(topic)


def precision_report(st, rows, ref_rows, label):
    """Hard-bit agreement and telemetry deviation against the reference
    rows, per carrying VFO over the blocks where the reference reports a
    signal."""
    tel = rows[:, st._soft_total:].copy().view(np.float32)
    ref_tel = ref_rows[:, st._soft_total:].copy().view(np.float32)
    per_vfo, worst = {}, 1.0
    dfreq = dmse = 0.0
    for topic in bank_carriers(st.cfg):
        cols, t0, nb = vfo_columns(st, topic)
        sig = ref_tel[:, t0] > 0.5
        if not sig.any():
            raise AssertionError(f"{label}: reference never locked {topic}")
        hard = rows[sig][:, cols] >= 128
        ref_hard = ref_rows[sig][:, cols] >= 128
        agree = float(np.mean(hard == ref_hard))
        per_vfo[topic] = agree
        worst = min(worst, agree)
        dmse = max(dmse, float(np.max(np.abs(
            tel[sig, t0 + nb] - ref_tel[sig, t0 + nb]))))
        dfreq = max(dfreq, float(np.max(np.abs(
            tel[sig, t0 + 3 * nb] - ref_tel[sig, t0 + 3 * nb]))))
    return {"hard_bit_agreement": per_vfo, "worst": worst,
            "max_freq_dev_hz": dfreq, "max_mse_dev": dmse}


def phase_precision(cfg, iq, block_len, want):
    """The 54W device step on the same IQ: GPU at default precision, GPU
    at highest, CPU float32.  Decodes (with topics) and hard bits."""
    import jax
    blocks = blocks_of(iq, block_len)
    runs = {}
    for label, ctx in (
            ("cpu_f32", jax.default_device(jax.devices("cpu")[0])),
            ("gpu_default", contextlib.nullcontext()),
            ("gpu_highest", jax.default_matmul_precision("highest"))):
        t0 = time.perf_counter()
        with ctx:
            st, got, _, rows = run_fused(cfg, blocks)
        compare_decoded(got, want, label)
        runs[label] = (st, rows)
        info("precision_run", run=label, decoded=sum(got.values()),
             wall_s=time.perf_counter() - t0)
    st, ref_rows = runs["cpu_f32"]
    for label in ("gpu_default", "gpu_highest"):
        rep = precision_report(st, runs[label][1], ref_rows, label)
        info("precision", run=label, against="cpu_f32", **rep)
        if rep["worst"] < HARD_BIT_AGREEMENT:
            raise AssertionError(
                f"{label}: hard-bit agreement {rep['worst']:.5f} with the "
                f"CPU is below {HARD_BIT_AGREEMENT}")


def phase_viterbi():
    import jax
    import jax.numpy as jnp
    from aero_tpu import native
    from aero_tpu.protocol.batch_framing import (HISTORY, LOOKAHEAD,
                                                 batch_decode_p_frames)
    from aero_tpu.protocol.framing import FRAME_SPECS
    from aero_tpu.protocol.viterbi import conv_encode, viterbi_decode_soft

    rng = np.random.default_rng(0)

    def noisy(n, n_bits):
        bits = rng.integers(0, 2, size=(n, n_bits)).astype(np.uint8)
        coded = np.stack([conv_encode(b) for b in bits]).astype(np.float32)
        return np.clip((coded * 2 - 1 + rng.normal(0, 0.5, coded.shape))
                       * 127 + 128, 0, 255).astype(np.float32)

    def native_all(soft):
        return np.stack([native.viterbi_decode_soft_native(s) for s in soft])

    # the old benchmark's shape: 128 streams of 2496 bits
    B, T = 128, 2496
    soft = noisy(B, T)
    dev = jax.jit(jax.vmap(viterbi_decode_soft))
    x = jnp.asarray(soft)
    t_dev = best_of(lambda: dev(x).block_until_ready())
    t_host = best_of(lambda: native_all(soft), 3)
    np.testing.assert_array_equal(np.asarray(dev(x)), native_all(soft))
    info("viterbi", shape=f"B={B} T={T}", gpu_scan_ms=1e3 * t_dev,
         native_host_ms=1e3 * t_host, gpu_mbit_s=B * T / t_dev / 1e6,
         native_mbit_s=B * T / t_host / 1e6)

    # one drain of the 54W bank with every P channel locked: frames per
    # 1.333 s block, padded to a power of two as BatchPChannelFramerBank
    # pads them
    block_s = 2048000 / 1536000
    for rate, n_vfos in ((1200, 21), (600, 3)):
        spec = FRAME_SPECS[rate]
        n = int(np.ceil(n_vfos * block_s * rate / spec.total_bits))
        n_pad = 1 << (n - 1).bit_length()
        coded = noisy(n_pad, spec.payload_info_bits + HISTORY // 2)
        pre, pay = coded[:, :HISTORY], coded[:, HISTORY:]
        pj, yj = jnp.asarray(pre), jnp.asarray(pay)

        def run_dev():
            return batch_decode_p_frames(yj, pj, rate=rate,
                                         pre_deinterleaved=True)[
                "info_bits"].block_until_ready()

        tail = np.full((n_pad, LOOKAHEAD), 128.0, np.float32)
        bufs = np.concatenate([pre, pay, tail], axis=1)
        t_dev = best_of(run_dev)
        t_host = best_of(lambda: native_all(bufs[:n]), 3)
        info("viterbi_bank_drain", rate=rate, frames=n, batch=n_pad,
             gpu_batch_ms=1e3 * t_dev, native_host_ms=1e3 * t_host)


def phase_four_cards():
    import jax
    from aero_tpu.channelizer import load_ini
    from aero_tpu.parallel.mesh import make_mesh
    from aero_tpu.synth import five_path_ini
    from aero_tpu.utils.profiling import enable_compile_cache
    enable_compile_cache()
    devs = require_gpu(jax.devices(), 4)
    info("device", jax=jax.__version__, kind=devs[0].device_kind,
         count=len(jax.devices()), xla_flags=os.environ.get("XLA_FLAGS", ""))
    cfg = load_ini(five_path_ini(4), is_text=True)
    block_len = block_len_of(cfg)
    iq, want, sent = four_card_traffic(cfg, block_len)
    blocks = blocks_of(iq, block_len)
    t0 = time.perf_counter()
    with jax.default_device(devs[0]):
        one, got1, voices1, rows1 = run_fused(cfg, blocks)
    t1 = time.perf_counter()
    mesh = make_mesh(4)
    four, got4, voices4, rows4 = run_fused(cfg, blocks, mesh=mesh)
    t4 = time.perf_counter()
    compare_decoded(got1, want, "one_card")
    compare_decoded(got4, got1, "four_cards")
    check_voice(voices1, "C0", sent, "one_card")
    if voices4 != voices1:
        raise AssertionError("four_cards: voice frames differ from one card")

    # every per-VFO leaf still split in quarters over the four cards after
    # the run: the uploaded block did not pull the step onto one device
    for key, g in four._state["grp"].items():
        for leaf in jax.tree.leaves(g):
            shards = leaf.addressable_shards
            if (len({s.device for s in shards}) != 4
                    or any(s.data.shape[0] * 4 != leaf.shape[0]
                           for s in shards)):
                raise AssertionError(f"group {key}: leaf {leaf.shape} not "
                                     f"split over 4 devices")
    tel1 = rows1[:, one._soft_total:].copy().view(np.float32)
    tel4 = rows4[:, four._soft_total:].copy().view(np.float32)
    dfreq = dmse = 0.0
    for key in one._order:
        if key[2]:
            continue
        nb, t0k = len(one.groups[key]), one._tel_ofs[key]
        dmse = max(dmse, float(np.max(np.abs(
            tel1[:, t0k + nb: t0k + 2 * nb] - tel4[:, t0k + nb: t0k + 2 * nb]))))
        dfreq = max(dfreq, float(np.max(np.abs(
            tel1[:, t0k + 3 * nb: t0k + 4 * nb]
            - tel4[:, t0k + 3 * nb: t0k + 4 * nb]))))
    if dfreq > FOUR_CARD_FREQ_TOL_HZ or dmse > FOUR_CARD_MSE_TOL:
        raise AssertionError(f"four_cards: telemetry differs from one card "
                             f"(freq {dfreq} Hz, mse {dmse})")
    info("four_cards", decoded=sorted(got4), voice_frames=len(voices4),
         max_freq_dev_hz=dfreq, max_mse_dev=dmse,
         one_card_wall_s=t1 - t0, four_card_wall_s=t4 - t1,
         iq_seconds=len(iq) / cfg.sample_rate)
    return devs[0], len(devs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only FusedStation.shard over four GPUs "
                         "against one GPU")
    args = ap.parse_args(argv)
    print(card_line(), flush=True)
    import jax
    # the GPU serves; the CPU backend runs the float32 reference
    jax.config.update("jax_platforms", "cuda,cpu")

    if args.four_cards:
        dev, count = phase_four_cards()
    else:
        dev = phase_device()
        ini_path, iq_path, cfg, block_len, iq, want, aes_topic = \
            prepare_bank()
        seconds = len(iq) / cfg.sample_rate
        phase_served("served", ini_path, iq_path, seconds, want, aes_topic)
        phase_served("served_int4_batch_framing", ini_path, iq_path,
                     seconds, want, aes_topic,
                     "--ingest-dtype", "int4", "--batch-framing")
        phase_mixed()
        phase_reference(ini_path, iq_path, want, aes_topic)
        phase_precision(cfg, iq, block_len, want)
        phase_viterbi()
        count = len(jax.devices())
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
