#!/usr/bin/env python3
"""Fixture-driven ACARS frame-parity harness (BASELINE's >= 95% metric).

Given a capture and its expected message list, decode the capture with
aero-tpu and report what fraction of the expected messages were
recovered — the comparison the reference's README TODO never implemented
("compare messages between JAERO and aero-decode ... we aren't losing
any data", ref /root/reference/README.md:33).  The expected.jsonl can
come from aero-decode/JAERO run on the same capture (real parity) or
from the TX builder that synthesized it (synthetic fixture).

Fixture layout (see tests/fixtures/README.md):
    <name>.wav | <name>.cf32     audio (single VFO) or wideband IQ
    <name>.expected.jsonl        one jsondump/jaero JSON object per line
    <name>.ini                   (cf32 only) channelizer INI

Usage:
    python tools/parity_check.py capture.wav expected.jsonl -b 1200
    python tools/parity_check.py wide.cf32 expected.jsonl -c settings.ini

Prints a human summary on stderr and ONE JSON line on stdout:
    {"parity_pct": 100.0, "ours": 3, "expected": 3, "matched": 3}
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def decode_capture(path: str, bitrate: int = 1200, ini: str | None = None,
                   station_id: str = "PARITY") -> list[str]:
    """Decode a capture file; returns jsondump lines."""
    from aero_tpu.io.output import to_output_format

    lines = []
    if path.endswith(".cf32"):
        import numpy as np
        from aero_tpu.channelizer import load_ini
        from aero_tpu.runtime.fused_station import FusedStation
        assert ini, "cf32 captures need a channelizer INI (-c)"
        cfg = load_ini(ini)
        items = []
        st = FusedStation(cfg, on_acars=lambda t, item: items.append(item))
        raw = np.fromfile(path, np.float32)
        wb = (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)
        wb = np.concatenate([wb, np.zeros(2 * st.block_len, np.complex64)])
        for i in range(0, (len(wb) // st.block_len) * st.block_len,
                       st.block_len):
            st.process(wb[i:i + st.block_len])
        st.flush()
        from aero_tpu.protocol.acars_apps import enrich
        for item in items:
            enrich(item)
            lines.append(to_output_format("jsondump", station_id, False,
                                          item))
    else:
        import contextlib
        import io as _io
        from aero_tpu.runtime.decoder import Decoder, DecoderOptions
        dec = Decoder(DecoderOptions(bitrate=bitrate, station_id=station_id))
        with contextlib.redirect_stdout(_io.StringIO()):
            dec.run_file(path)
        for item in dec.items:
            lines.append(to_output_format("jsondump", station_id, False,
                                          item))
    return lines


def parity(ours_lines: list[str], expected_path: str) -> dict:
    """expected.jsonl accepts BOTH reference output formats: jsondump
    (nested isu) and the jaero flat JSON (AESID/GESID/LABEL/REG, no
    text; ref decode/output.cpp:107-127) — with jaero expectations the
    match drops message text from both sides."""
    from tools.frame_diff import _key, keys_comparable
    ours_keys = [k for k in (_key(ln) for ln in ours_lines) if k]
    expected = []
    with open(expected_path) as f:
        for line in f:
            k = _key(line.strip())
            if k:
                expected.append(k)
    ours, exp_set = keys_comparable(ours_keys, expected)
    matched = ours & exp_set
    return {
        "parity_pct": round(100.0 * len(matched) / max(1, len(exp_set)), 1),
        "ours": len(ours),
        "expected": len(exp_set),
        "matched": len(matched),
        "missing": sorted(exp_set - ours)[:10],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("capture")
    ap.add_argument("expected")
    ap.add_argument("-b", "--bitrate", type=int, default=1200)
    ap.add_argument("-c", "--ini", default=None)
    ap.add_argument("--min-parity", type=float, default=None,
                    help="exit 1 below this percentage")
    ap.add_argument("--platform", default="cpu",
                    help="JAX platform (default cpu; cuda runs a cf32 "
                         "capture's station on the GPU)")
    args = ap.parse_args(argv)
    import jax
    jax.config.update("jax_platforms", args.platform)
    ours = decode_capture(args.capture, args.bitrate, args.ini)
    rep = parity(ours, args.expected)
    missing = rep.pop("missing")
    for m in missing:
        print(f"missing: {m}", file=sys.stderr)
    print(f"parity {rep['parity_pct']}% "
          f"({rep['matched']}/{rep['expected']} expected messages; "
          f"we decoded {rep['ours']})", file=sys.stderr)
    print(json.dumps(rep))
    if args.min_parity is not None and rep["parity_pct"] < args.min_parity:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
