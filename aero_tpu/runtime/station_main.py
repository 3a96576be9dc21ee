"""aero-station CLI: the full receive chain in one process.

The configuration aero-cli cannot express (SURVEY.md §2.5): one wideband
IQ stream, every VFO channelized + demodulated + decoded in-process, ACARS
on stdout/forwarders, periodic stats on stderr.  The first stderr line
names the device: {"device": {"platform", "kind", "count"}}.

Usage:
  python -m aero_tpu.runtime.station_main -c settings.ini --iq-file wide.cf32
  python -m aero_tpu.runtime.station_main -c settings.ini --iq-stdin \
      --format jsondump -f jsondump=tcp://host:5571
  python -m aero_tpu.runtime.station_main -c settings.ini --iq-file wide.cf32 \
      --platform cpu          # hosts without a GPU
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aero-station",
        description="full-chain Inmarsat Aero station")
    p.add_argument("-c", "--settings", required=True)
    p.add_argument("--iq-file", default=None, help="cf32 interleaved IQ")
    p.add_argument("--iq-stdin", action="store_true")
    p.add_argument("--loop", action="store_true")
    p.add_argument("--backend", default="fused",
                   choices=["tree", "pfb", "fused"],
                   help="fused (default): device-resident one-jit-per-block "
                        "served path; tree/pfb: classic reference-shaped "
                        "station, which moves per-VFO audio between host "
                        "and device and is kept for comparison")
    p.add_argument("--ingest-dtype", default="int16",
                   choices=["int2", "int4", "int8", "int16", "float32"],
                   help="fused backend host->device IQ quantization")
    p.add_argument("--format", default="jsondump",
                   choices=["jaero", "jsondump", "text"])
    p.add_argument("-s", "--station-id",
                   default=f"{socket.gethostname()}-AERO-INMARSAT")
    p.add_argument("-f", "--forwarder", action="append", default=[],
                   metavar="FMT=URL")
    p.add_argument("--platform", default="cuda",
                   help="JAX platform (default cuda: start fails when the "
                        "GPU cannot be opened; pass cpu on hosts without "
                        "one)")
    p.add_argument("--stats-every", type=float, default=10.0,
                   help="seconds between stats lines on stderr")
    p.add_argument("--aircraft-db", default=None, metavar="CSV",
                   help="aircraft registration DB CSV "
                        "(ICAO24,Registration,... — protocol/database.py)")
    p.add_argument("--voice-out", default=None, metavar="FILE",
                   help="append C-channel voice codec frames (300 B per "
                        "frame, as decoded) to this file")
    p.add_argument("--batch-framing", action="store_true",
                   help="fused backend: decode all P-channel frames of a "
                        "rate group in ONE batched device call per drain "
                        "(protocol/batch_framing.py; host framing at "
                        "hundreds-of-VFOs scale)")
    p.add_argument("--checkpoint", default=None, metavar="FILE",
                   help="resume from FILE at startup when it exists, and "
                        "save the full station state there periodically "
                        "and at shutdown (runtime/checkpoint.py)")
    p.add_argument("--checkpoint-every", type=float, default=300.0,
                   metavar="SEC", help="seconds between checkpoint saves")
    p.add_argument("--no-hunt", action="store_true",
                   help="disable per-VFO signal hunting (the reference's "
                        "SignalHunter scan; ref decode/decode.cpp:161-226)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    t_start = time.perf_counter()
    import jax
    jax.config.update("jax_platforms", args.platform)
    from aero_tpu.utils.profiling import enable_compile_cache
    enable_compile_cache()
    devices = jax.devices()
    print(json.dumps({"device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)}}),
          file=sys.stderr, flush=True)
    from aero_tpu.channelizer import load_ini
    from aero_tpu.runtime.station import Station
    from aero_tpu.io.output import to_output_format
    from aero_tpu.io.forwarder import (AsyncForwardQueue, ForwardTarget,
                                       parse_forwarder)
    from aero_tpu.protocol.acars_apps import enrich

    cfg = load_ini(args.settings)
    # comma-separated lists in one flag match the reference CLI
    # (ref decode/main.cpp:26-29); repeated flags also work
    targets = [ForwardTarget(parse_forwarder(s))
               for v in args.forwarder for s in v.split(",") if s]
    # egress decoupled from the decode loop (ref decode.cpp:368-416) —
    # a stalled TCP sink must not stall the station
    fwd = AsyncForwardQueue(targets) if targets else None

    def on_acars(topic, item):
        enrich(item)
        line = to_output_format(args.format, args.station_id, False, item)
        print(line, flush=True)
        if fwd is not None:
            fwd.submit(args.station_id, False, item)

    voice_f = open(args.voice_out, "ab") if args.voice_out else None

    def on_voice(topic, data, hex_aes):
        if voice_f is not None:
            voice_f.write(data)
            voice_f.flush()

    def mk_station():
        if args.backend == "fused":
            from aero_tpu.runtime.fused_station import FusedStation
            return FusedStation(cfg, on_acars=on_acars, on_voice=on_voice,
                                station_id=args.station_id,
                                ingest_dtype=args.ingest_dtype,
                                aircraft_db=args.aircraft_db,
                                hunt=not args.no_hunt,
                                batch_host_framing=args.batch_framing)
        n_vfos = len(cfg.mains) + len(cfg.subs)
        if n_vfos > 8:
            print(f"warning: --backend {args.backend} is the classic "
                  f"comparison shape and may not keep up with {n_vfos} "
                  f"VFOs; the default fused backend is the served path",
                  file=sys.stderr)
        return Station(cfg, on_acars=on_acars, on_voice=on_voice,
                       station_id=args.station_id, backend=args.backend,
                       aircraft_db=args.aircraft_db,
                       hunt=not args.no_hunt)

    st = mk_station()
    B = st.block_len if args.backend == "fused" else cfg.buflen_complex
    initial_carry = np.zeros(0, np.complex64)
    if args.checkpoint and os.path.exists(args.checkpoint):
        # a truncated/incompatible checkpoint must not crash-loop the
        # station: warn and start fresh (the periodic save will replace
        # it atomically — runtime/checkpoint.py _atomic_savez)
        try:
            st.load_checkpoint(args.checkpoint)
            from aero_tpu.runtime.checkpoint import load_residual
            initial_carry = load_residual(args.checkpoint)
            print(json.dumps({"resumed_from": args.checkpoint,
                              "residual_samples": len(initial_carry)}),
                  file=sys.stderr, flush=True)
        except Exception as e:
            print(json.dumps({"checkpoint_load_failed": str(e),
                              "action": "starting fresh"}),
                  file=sys.stderr, flush=True)
            # a failed load can leave the station HALF-restored (device
            # state assigned before a later framer blob raised): rebuild
            # so "starting fresh" means what it says
            st = mk_station()
    last_ckpt = time.time()
    last_stats = time.time()

    # SIGINT/SIGTERM stop the pump cleanly (then stats flush below);
    # SIGHUP dumps a stats line on demand (EventNotifier parity,
    # ref common/notifier.cpp wired in decode/main.cpp).
    from aero_tpu.utils.signals import EventNotifier

    def hup_stats():
        s = st.stats
        dump = {"wideband_samples": s.wideband_samples, "frames": s.frames,
                "su_ok": s.su_ok, "su_bad": s.su_bad, "acars": s.acars,
                "burst_windows": s.burst_windows,
                "burst_packets": s.burst_packets}
        # fused backend: per-VFO signal/mse/ebno/freq + burst counters
        if hasattr(st, "vfo_telemetry"):
            dump["vfos"] = st.vfo_telemetry()
        print(json.dumps({"stats_on_sighup": dump}),
              file=sys.stderr, flush=True)

    notifier = EventNotifier(on_hangup=hup_stats).install()

    carry_box = [initial_carry]     # pump residual, persisted in ckpts
    first_block = []                # seconds from start to block 1 done

    def pump(reader):
        nonlocal last_stats, last_ckpt
        carry = carry_box[0]
        for chunk in reader:
            if notifier.stop_requested:
                break
            carry = np.concatenate([carry, chunk])
            while len(carry) >= B:
                st.process(carry[:B])
                carry = carry[B:]
                if not first_block:
                    first_block.append(time.perf_counter() - t_start)
            carry_box[0] = carry
            if (args.checkpoint
                    and time.time() - last_ckpt >= args.checkpoint_every):
                last_ckpt = time.time()
                st.save_checkpoint(args.checkpoint, residual=carry)
            if time.time() - last_stats >= args.stats_every:
                last_stats = time.time()
                s = st.stats
                print(json.dumps({
                    "stats": {
                        "wideband_samples": s.wideband_samples,
                        "realtime_factor": round(
                            s.realtime_factor / cfg.sample_rate, 2),
                        "frames": s.frames, "su_ok": s.su_ok,
                        "su_bad": s.su_bad, "acars": s.acars,
                        "burst_windows": s.burst_windows,
                        "burst_packets": s.burst_packets,
                    }}), file=sys.stderr, flush=True)
        if hasattr(st, "flush"):
            st.flush()       # drain the pipelined in-flight block

    if args.iq_file:
        def reader():
            while True:
                yield np.fromfile(args.iq_file, dtype=np.complex64)
                if not args.loop:
                    return
        pump(reader())
    elif args.iq_stdin:
        def reader():
            while True:
                raw = sys.stdin.buffer.read(B * 8)
                if not raw:
                    return
                yield np.frombuffer(raw, np.complex64)
        pump(reader())
    else:
        print("no input: use --iq-file or --iq-stdin", file=sys.stderr)
        return 2

    s = st.stats
    final = {"wideband_samples": s.wideband_samples,
             "frames": s.frames, "su_ok": s.su_ok, "su_bad": s.su_bad,
             "acars": s.acars,
             "first_block_s": first_block[0] if first_block else None,
             "wall_s": time.perf_counter() - t_start}
    if fwd is not None:
        fwd.flush()
        fwd.close()
        final["forwarded"] = fwd.sent
        final["forward_dropped"] = fwd.dropped
        final["forward_errors"] = fwd.errors
    if voice_f is not None:
        final["voice_frames"] = s.voice_frames
        voice_f.close()
    if args.checkpoint:
        st.save_checkpoint(args.checkpoint, residual=carry_box[0])
        final["checkpoint"] = args.checkpoint
    print(json.dumps({"final_stats": final}), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
