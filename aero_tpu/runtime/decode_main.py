"""aero-decode CLI equivalent (ref: decode/main.cpp:12-107).

Usage examples:
  python -m aero_tpu.runtime.decode_main -b 1200 -p tcp://127.0.0.1:5555 -t VFO1
  python -m aero_tpu.runtime.decode_main -b 1200 --input-file capture.wav
  python -m aero_tpu.runtime.decode_main -b 600 -f jsondump=tcp://host:5571 ...
"""

from __future__ import annotations

import argparse
import socket
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="aero-decode",
        description="Inmarsat Aero demodulator/decoder")
    p.add_argument("-b", "--bit-rate", type=int, default=600,
                   choices=[600, 1200, 8400, 10500],
                   help="channel bit rate")
    p.add_argument("-f", "--forwarder", action="append", default=[],
                   metavar="FMT=URL",
                   help="forward decoded frames (tcp/udp), e.g. "
                        "jsondump=tcp://host:5571; repeatable")
    p.add_argument("-p", "--publisher", default="tcp://127.0.0.1:5555",
                   help="ZMQ publisher URL to consume")
    p.add_argument("-s", "--station-id",
                   default=f"{socket.gethostname()}-AERO-INMARSAT",
                   help="station id for output (ref: main.cpp:75-80)")
    p.add_argument("-t", "--topic", default="VFO1", help="ZMQ topic")
    p.add_argument("--burst", action="store_true",
                   help="burst (R/T channel) demodulation")
    p.add_argument("--disable-reassembly", action="store_true")
    p.add_argument("--format", default="jsondump",
                   choices=["jaero", "jsondump", "text"])
    p.add_argument("--no-signal-exit", action="store_true",
                   help="exit after a full futile frequency scan")
    p.add_argument("--input-file", default=None,
                   help="decode a WAV/raw-PCM file instead of ZMQ")
    p.add_argument("--input-rate", type=int, default=None,
                   help="sample rate for raw input files")
    p.add_argument("--aircraft-db", default=None, metavar="CSV",
                   help="aircraft registration DB CSV "
                        "(ICAO24,Registration,... — protocol/database.py)")
    p.add_argument("--voice-out", default=None,
                   help="write C-channel voice codec frames to this file")
    p.add_argument("--platform", default="cpu",
                   help="JAX platform for this process (default cpu: "
                        "aero-decode runs one process per VFO, and a JAX "
                        "process reserves most of a GPU's memory when it "
                        "opens it, so a second decoder on the same GPU "
                        "would fail; the GPU serves the whole bank through "
                        "aero_tpu.runtime.station_main)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import jax
    jax.config.update("jax_platforms", args.platform)
    from aero_tpu.utils.profiling import enable_compile_cache
    enable_compile_cache()
    from aero_tpu.runtime.decoder import Decoder, DecoderOptions

    opts = DecoderOptions(
        bitrate=args.bit_rate,
        burst=args.burst,
        station_id=args.station_id,
        fmt=args.format,
        # the reference's -f accepts a comma-separated list in one flag
        # (FORMAT1=URL1,FORMAT2=URL2; ref decode/main.cpp:26-29) — accept
        # both that form and repeated flags
        forwarders=[s for v in args.forwarder
                    for s in v.split(",") if s],
        disable_reassembly=args.disable_reassembly,
        no_signal_exit=args.no_signal_exit,
        voice_out=args.voice_out,
        aircraft_db=args.aircraft_db,
        verbose=args.verbose,
    )
    dec = Decoder(opts)
    from aero_tpu.utils.signals import EventNotifier
    notifier = EventNotifier().install()
    if args.input_file:
        dec.run_file(args.input_file, args.input_rate)
    else:
        dec.run_zmq(args.publisher, args.topic, notifier=notifier)
    return 0


if __name__ == "__main__":
    sys.exit(main())
