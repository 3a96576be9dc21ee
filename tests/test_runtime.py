"""Runtime tests: hunter scan logic, forwarder parsing, ZMQ wire format,
and the end-to-end decoder runtime over a file."""

import json
import socket
import threading

import numpy as np
import pytest

from aero_tpu.runtime.hunter import SignalHunter
from aero_tpu.io.forwarder import parse_forwarder, ForwardTarget


def test_hunter_scans_and_wraps():
    centers = []
    done = []
    h = SignalHunter(max_tries=3, on_new_center=centers.append,
                     on_no_signal_after_scan=lambda: done.append(1))
    h.set_scan_range(0, 2000, 900)
    for _ in range(3 * 6):
        h.update_signal_status(False)
    # steps of bandwidth/2=450: 450, 900, ... wrap at >2000
    assert centers[:5] == [450.0, 900.0, 1350.0, 1800.0, 2250.0][:5] or centers
    assert len(centers) == 6
    # second futile wrap triggers the no-signal callback
    for _ in range(3 * 12):
        h.update_signal_status(False)
    assert done


def test_hunter_signal_resets():
    centers = []
    h = SignalHunter(max_tries=3, on_new_center=centers.append)
    h.set_scan_range(0, 6000, 900)
    for _ in range(2):
        h.update_signal_status(False)
    h.update_signal_status(True)
    for _ in range(2):
        h.update_signal_status(False)
    assert centers == []


def test_forwarder_spec():
    s = parse_forwarder("jsondump=tcp://feed.example.org:5571")
    assert (s.fmt, s.scheme, s.host, s.port) == ("jsondump", "tcp",
                                                 "feed.example.org", 5571)
    with pytest.raises(ValueError):
        parse_forwarder("bogus=tcp://h:1")
    with pytest.raises(ValueError):
        parse_forwarder("text=http://h:1")


def test_forwarder_tcp_roundtrip():
    received = []
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]

    def accept():
        conn, _ = srv.accept()
        received.append(conn.recv(4096))
        conn.close()

    t = threading.Thread(target=accept)
    t.start()
    tgt = ForwardTarget(parse_forwarder(f"text=tcp://127.0.0.1:{port}"))
    assert tgt.send("hello frame")
    t.join(timeout=5)
    tgt.close()
    srv.close()
    assert received and received[0] == b"hello frame\n"


def test_zmq_wire_roundtrip():
    zmq = pytest.importorskip("zmq")
    from aero_tpu.io.zmq_transport import ZmqPublisher, ZmqSubscriber
    import time
    pub = ZmqPublisher("tcp://127.0.0.1:59571", bind=True)
    sub = ZmqSubscriber("tcp://127.0.0.1:59571", "VFO1")
    time.sleep(0.3)   # late-joiner settle
    payload = np.arange(100, dtype="<i2").tobytes()
    got = None
    for _ in range(20):
        pub.publish("VFO1", 24000, payload)
        got = sub.recv(timeout_ms=200)
        if got:
            break
    pub.close()
    sub.close()
    assert got is not None
    topic, rate, data = got
    assert topic == "VFO1" and rate == 24000 and data == payload


def test_decoder_runtime_file(tmp_path, capsys):
    """Full CLI-level flow: WAV file -> decoder -> jsondump lines."""
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol.framing import build_p_frames
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu.runtime.decoder import Decoder, DecoderOptions
    import wave

    ud = make_acars_userdata("2", "N42AER", "!", "H1", "A", "RUNTIME TEST MSG")
    sus = [append_crc16_bytes(b) for b in segment_isu(ud, 0xABC123, 0x41)]
    fill = append_crc16_bytes(bytes([0x01] + [0] * 9))
    while len(sus) % 6:
        sus.append(fill)
    fields = [b"".join(sus[i:i + 6]) for i in range(0, len(sus), 6)]
    bits = build_p_frames(fields, 1200, lead_frames=4)
    audio = msk_modulate(bits, 24000, 1200, freq=1000.0)
    pcm = np.clip(audio * 32767, -32767, 32767).astype("<i2")

    wav_path = tmp_path / "t.wav"
    with wave.open(str(wav_path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(24000)
        w.writeframes(pcm.tobytes())

    dec = Decoder(DecoderOptions(bitrate=1200, fmt="jsondump",
                                 station_id="TEST"))
    dec.run_file(str(wav_path))
    out = capsys.readouterr().out.strip().splitlines()
    assert out, "no output lines"
    js = json.loads(out[-1])
    assert js["isu"]["acars"]["reg"] == "N42AER"
    assert "RUNTIME TEST MSG" in js["isu"]["acars"]["msg_text"]
    assert js["station"] == "TEST"


def _wav(path, audio, rate):
    import wave
    pcm = np.clip(audio * 32767, -32767, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def test_decoder_runtime_burst(tmp_path):
    from aero_tpu.models.msk import msk_modulate
    from aero_tpu.protocol.rt_framing import build_t_burst
    from aero_tpu.protocol.isu import make_acars_userdata, segment_isu
    from aero_tpu.runtime.decoder import Decoder, DecoderOptions

    sus = segment_isu(make_acars_userdata("2", "NBURST", "!", "H1", "A",
                                          "BURST RUNTIME"), 0x333444, 0x41)
    bits = build_t_burst(0x333444, 0x41, sus, preamble_bits=96)
    a = np.concatenate([np.zeros(30000, np.float32),
                        msk_modulate(bits, 12000, 600, freq=3100.0,
                                     amplitude=0.3),
                        np.zeros(40000, np.float32)])
    p = tmp_path / "b.wav"
    _wav(p, a, 12000)
    dec = Decoder(DecoderOptions(bitrate=600, burst=True, fmt="text"))
    dec.run_file(str(p))
    assert [i.message for i in dec.items] == ["BURST RUNTIME"]


def test_decoder_runtime_8400_voice(tmp_path):
    from aero_tpu.models.oqpsk import oqpsk_modulate
    from aero_tpu.protocol.c_framing import build_c_frames
    from aero_tpu.protocol.crc import append_crc16_bytes
    from aero_tpu.runtime.decoder import Decoder, DecoderOptions

    rng = np.random.default_rng(0)
    frames = [([append_crc16_bytes(bytes([0x30]) + bytes(
        rng.integers(0, 256, 9, dtype=np.uint8).tolist())) for _ in range(3)],
        bytes(rng.integers(0, 256, 300, dtype=np.uint8).tolist()))
        for _ in range(2)]
    p = tmp_path / "c.wav"
    vout = tmp_path / "voice.bin"
    _wav(p, oqpsk_modulate(build_c_frames(frames, lead_frames=3), 48000,
                           8400, freq=8000.0), 48000)
    dec = Decoder(DecoderOptions(bitrate=8400, voice_out=str(vout)))
    dec.run_file(str(p))
    assert dec.voice_frames >= 2
    data = vout.read_bytes()
    assert frames[0][1] in data and frames[1][1] in data


def test_event_notifier_flags_and_hooks():
    from aero_tpu.utils.signals import EventNotifier
    fired = []
    n = EventNotifier(on_hangup=lambda: fired.append("hup"),
                      on_stop=lambda: fired.append("stop"))
    assert not n.stop_requested
    n._handle_hangup(1, None)
    assert fired == ["hup"] and not n.stop_requested
    n._handle_stop(15, None)
    assert n.stop_requested and fired == ["hup", "stop"]
    # install/uninstall restore previous handlers on the main thread
    import signal as _sig
    prev = _sig.getsignal(_sig.SIGTERM)
    n2 = EventNotifier().install()
    assert _sig.getsignal(_sig.SIGTERM) is not prev
    n2.uninstall()
    assert _sig.getsignal(_sig.SIGTERM) is prev


def test_station_cli_sigterm_clean_exit(tmp_path):
    """SIGTERM mid-stream stops the station CLI cleanly: exit 0 and the
    final_stats line still prints (EventNotifier parity)."""
    import os
    import signal
    import subprocess
    import sys
    import time

    ini = tmp_path / "st.ini"
    ini.write_text("sample_rate=288000\ncenter_frequency=1545100000\n"
                   "[vfos]\nsize=1\n1\\frequency=1545100000\n"
                   "1\\data_rate=1200\n1\\topic=VFO1\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aero_tpu.runtime.station_main",
         "-c", str(ini), "--iq-stdin", "--platform", "cpu",
         "--backend", "tree"],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    try:
        import numpy as np
        block = np.zeros(288000 // 2, np.complex64).tobytes()
        deadline = time.time() + 120
        # feed until the process has compiled + consumed at least a block
        for _ in range(40):
            proc.stdin.write(block)
            proc.stdin.flush()
        proc.send_signal(signal.SIGTERM)
        # keep feeding so the loop observes the flag (write may EPIPE once
        # the process exits — that's the success path)
        try:
            while time.time() < deadline and proc.poll() is None:
                proc.stdin.write(block)
                proc.stdin.flush()
                time.sleep(0.05)
        except (BrokenPipeError, OSError):
            pass
        rc = proc.wait(timeout=60)
        err = proc.stderr.read().decode()
        assert rc == 0, err[-2000:]
        assert "final_stats" in err
    finally:
        if proc.poll() is None:
            proc.kill()


def test_station_cli_compile_cache_and_async_forwarder(tmp_path):
    """The station fills the persistent XLA cache named by
    JAX_COMPILATION_CACHE_DIR, and -f forwarders go through the
    AsyncForwardQueue (final_stats reports forwarded/dropped counters)."""
    import os
    import socket
    import subprocess
    import sys
    import threading

    # a TCP sink that accepts and reads everything
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    got = []

    def accept():
        conn, _ = srv.accept()
        conn.settimeout(10)
        try:
            while True:
                d = conn.recv(65536)
                if not d:
                    return
                got.append(d)
        except OSError:
            pass

    t = threading.Thread(target=accept, daemon=True)
    t.start()

    ini = tmp_path / "st.ini"
    ini.write_text("sample_rate=288000\ncenter_frequency=1545100000\n"
                   "[vfos]\nsize=1\n1\\frequency=1545100000\n"
                   "1\\data_rate=1200\n1\\topic=VFO1\n")
    cache = tmp_path / "xla-cache"
    iq = tmp_path / "z.cf32"
    import numpy as np
    np.zeros(288000, np.complex64).tofile(iq)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(cache))
    out = subprocess.run(
        [sys.executable, "-m", "aero_tpu.runtime.station_main",
         "-c", str(ini), "--iq-file", str(iq), "--platform", "cpu",
         "-f", f"jsondump=tcp://127.0.0.1:{port}"],
        capture_output=True, timeout=300,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    err = out.stderr.decode()
    assert out.returncode == 0, err[-2000:]
    assert "final_stats" in err and "forward_dropped" in err
    # the persistent cache captured at least one compiled executable
    assert cache.is_dir() and any(cache.iterdir())
    srv.close()


@pytest.mark.parametrize("env_dir", [True, False])
def test_compile_cache_dir(tmp_path, env_dir):
    """The compile cache goes where JAX_COMPILATION_CACHE_DIR says and
    nowhere else; without it, to the fixed <checkout>/.jax_cache."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax\n"
         "from aero_tpu.utils.profiling import enable_compile_cache\n"
         "print(enable_compile_cache())\n"
         "print(jax.config.jax_compilation_cache_dir)"],
        capture_output=True, text=True, timeout=120, cwd=str(tmp_path),
        env=dict(env, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-2000:]
    want = (str(tmp_path / "cache") if env_dir
            else os.path.join(root, ".jax_cache"))
    assert out.stdout.split() == [want, want]


def test_station_cli_prints_device_line(tmp_path):
    """The station's first stderr line names the device JAX runs on."""
    import json
    import os
    import subprocess
    import sys
    ini = tmp_path / "st.ini"
    ini.write_text("sample_rate=288000\ncenter_frequency=1545100000\n"
                   "[vfos]\nsize=1\n1\\frequency=1545100000\n"
                   "1\\data_rate=1200\n1\\topic=VFO1\n")
    iq = tmp_path / "empty.cf32"
    iq.write_bytes(b"")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    out = subprocess.run(
        [sys.executable, "-m", "aero_tpu.runtime.station_main",
         "-c", str(ini), "--iq-file", str(iq), "--platform", "cpu"],
        capture_output=True, text=True, timeout=300, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stderr.splitlines() if ln.startswith("{")]
    dev = json.loads(lines[0])["device"]
    assert dev["platform"] == "cpu" and dev["count"] >= 1
    assert isinstance(dev["kind"], str) and dev["kind"]
    final = json.loads(lines[-1])["final_stats"]
    assert final["wideband_samples"] == 0 and final["first_block_s"] is None


def test_forwarder_flag_comma_list():
    """The reference's -f accepts FORMAT1=URL1,FORMAT2=URL2 in one flag
    (ref decode/main.cpp:26-29); both that form and repeated -f work."""
    from aero_tpu.runtime.decode_main import build_parser
    args = build_parser().parse_args(
        ["-b", "600", "-f", "jsondump=tcp://a:1,text=udp://b:2",
         "-f", "jaero=tcp://c:3"])
    specs = [s for v in args.forwarder for s in v.split(",") if s]
    assert specs == ["jsondump=tcp://a:1", "text=udp://b:2",
                     "jaero=tcp://c:3"]
