"""Render daemon: JSON-line protocol, warm-engine renders, error isolation."""

import json
import threading

import numpy as np
import pytest

from jefferson_tpu.engine.renderer import Renderer
from jefferson_tpu.io.wavio import read_wav, write_wav
from jefferson_tpu.serve import RenderService, request, serve
from jefferson_tpu.testing import precision_check
from jefferson_tpu.trajectory.trajectory import CircularOrbit


@pytest.fixture(scope="module")
def daemon(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("serve")
    sock = tmp / "jt.sock"
    service = RenderService(hrtf_dir=None, chunk_blocks=64)
    t = threading.Thread(target=serve, args=(sock, service), daemon=True)
    t.start()
    # wait until the socket accepts
    for _ in range(200):
        try:
            assert request(sock, {"cmd": "ping"})["pong"]
            break
        except (ConnectionRefusedError, FileNotFoundError, OSError):
            import time

            time.sleep(0.05)
    yield sock, service
    request(sock, {"cmd": "shutdown"})
    t.join(timeout=5)


def test_daemon_renders_match_direct(daemon, db, config, castanets, tmp_path):
    sock, service = daemon
    src = tmp_path / "in.wav"
    write_wav(src, castanets[:, None].repeat(2, 1), config.sample_rate)
    out = tmp_path / "out.wav"
    resp = request(sock, {
        "cmd": "render", "id": 7, "input": str(src), "output": str(out),
        "trajectory": "orbit:period=1,ele=5,r=1.0", "blocks": 64, "float": True,
        "bits": 32,
    })
    assert resp["ok"] and resp["id"] == 7 and resp["blocks"] == 64

    pos = CircularOrbit(period_s=1.0, ele=5, r=1.0).sample(64, config)
    want = Renderer(service.db, config, chunk_blocks=64).render(
        read_wav(src)[0].mean(axis=1).astype(np.float32), pos
    )
    got, sr = read_wav(out)
    assert sr == config.sample_rate
    rep = precision_check(got, want, eps=1e-6)
    assert rep.ok, str(rep)


def test_daemon_scene(daemon, db, config, castanets, tmp_path):
    """Multi-source scene request through the daemon == CLI scene path."""
    sock, service = daemon
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    write_wav(a, castanets[:6000], config.sample_rate)
    write_wav(b, np.roll(castanets, 500)[:6000], config.sample_rate)
    out = tmp_path / "mix.wav"
    scene = {"sources": [
        {"input": str(a), "trajectory": "static:azi=60,ele=0,r=1.0", "gain": 0.8},
        {"input": str(b), "trajectory": "orbit:period=0.5,ele=5,r=1.2"},
    ]}
    resp = request(sock, {"cmd": "scene", "scene": scene, "output": str(out),
                          "blocks": 32, "float": True, "bits": 32})
    assert resp["ok"] and resp["sources"] == 2 and resp["blocks"] == 32
    y, sr = read_wav(out)
    assert sr == config.sample_rate and y.shape == (32 * config.frames_per_buffer, 2)
    assert np.isfinite(y).all() and np.abs(y).max() > 0
    # an invalid client chunk size errors cleanly (no obscure range/zero-step
    # failure from inside the render loop) and the daemon survives
    bad = request(sock, {"cmd": "scene", "scene": scene, "output": str(out),
                         "blocks": 32, "chunk_blocks": 0})
    assert not bad["ok"] and "must be positive" in bad["error"]
    assert request(sock, {"cmd": "ping"})["pong"]


def test_daemon_stats_and_errors(daemon, tmp_path):
    sock, service = daemon
    stats = request(sock, {"cmd": "stats"})
    assert stats["ok"] and stats["renders"] >= 1

    resp = request(sock, {"cmd": "render", "input": str(tmp_path / "missing.wav"),
                          "output": str(tmp_path / "x.wav")})
    assert not resp["ok"] and "error" in resp
    # daemon survives the error
    assert request(sock, {"cmd": "ping"})["pong"]
    assert request(sock, {"cmd": "nope"})["ok"] is False


def test_daemon_live_stream_with_moves(daemon, db, config, castanets, tmp_path):
    """Live stream session: start, move the source mid-stream (spherical,
    key, and Cartesian forms), stop -> deadline stats + crossfade count."""
    import time

    sock, service = daemon
    src = tmp_path / "live_in.wav"
    write_wav(src, castanets[:8000, None].repeat(2, 1), config.sample_rate)
    out = tmp_path / "live_out.wav"

    resp = request(sock, {
        "cmd": "stream_start", "input": str(src), "output": str(out),
        "seconds": 10.0, "paced": True,
    })
    assert resp["ok"], resp
    sid = resp["session"]

    def wait_blocks(n, timeout_s=30.0):
        """Block until the paced loop has emitted >= n blocks (prime absorbs
        the first jit compile, so the first block can take seconds)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            if service._streams[sid]["play"].stats.blocks >= n:
                return
            time.sleep(0.02)
        raise AssertionError(f"stream never reached {n} blocks")

    # paced stream: moves land between blocks like the reference's key thread
    wait_blocks(4)
    mv = request(sock, {"cmd": "move", "azi": 90, "ele": 10, "r": 1.0})
    assert mv["ok"] and mv["azi"] == 90 and mv["ele"] == 10, mv
    wait_blocks(service._streams[sid]["play"].stats.blocks + 4)
    mv = request(sock, {"cmd": "move", "key": "w"})
    assert mv["ok"]
    wait_blocks(service._streams[sid]["play"].stats.blocks + 4)
    mv = request(sock, {"cmd": "move", "x": 0.5, "y": 0.0, "z": -0.5})
    # atan2(-x, -z) convention (SoundSource.cu:29): (0.5, -0.5) -> 315 deg
    assert mv["ok"] and mv["azi"] == 315, mv
    wait_blocks(service._streams[sid]["play"].stats.blocks + 4)

    stats = request(sock, {"cmd": "stream_stop"})
    assert stats["ok"], stats
    assert stats["blocks"] > 0
    assert stats["crossfades"] >= 2, stats  # the moves fired crossfades
    got, sr = read_wav(out)
    assert sr == config.sample_rate and got.shape[0] == stats["blocks"] * 128
    assert np.isfinite(got).all()

    # stopping again -> clean error
    assert not request(sock, {"cmd": "stream_stop"})["ok"]
    # move with no session -> clean error
    assert not request(sock, {"cmd": "move", "azi": 0})["ok"]


def test_daemon_move_rejects_unknown_fields(daemon, db, config, castanets, tmp_path):
    """A typo'd move must error, not silently snap the position through the
    degree-rounded spherical round-trip while reporting ok."""
    sock, service = daemon
    src = tmp_path / "mv_in.wav"
    write_wav(src, castanets[:4000, None].repeat(2, 1), config.sample_rate)
    out = tmp_path / "mv_out.wav"
    assert request(sock, {"cmd": "stream_start", "input": str(src),
                          "output": str(out), "seconds": 5, "paced": True})["ok"]
    try:
        bad = request(sock, {"cmd": "move", "azimuth": 90})  # typo'd field
        assert not bad["ok"] and "move needs one of" in bad["error"]
        bare = request(sock, {"cmd": "move"})
        assert not bare["ok"]
    finally:
        request(sock, {"cmd": "stream_stop"})


def test_daemon_move_after_stream_end_rejected(daemon, db, config, castanets, tmp_path):
    """A move landing after the session's block loop has finished (natural
    end or racing teardown) must report ok:false, not ok against a dead
    stream (round-3 verdict weak item)."""
    import time

    sock, service = daemon
    src = tmp_path / "end_in.wav"
    write_wav(src, castanets[:2000, None].repeat(2, 1), config.sample_rate)
    out = tmp_path / "end_out.wav"
    resp = request(sock, {"cmd": "stream_start", "input": str(src),
                          "output": str(out), "seconds": 0.05, "paced": False})
    assert resp["ok"], resp
    sid = resp["session"]
    th = service._streams[sid]["thread"]
    th.join(timeout=30)
    assert not th.is_alive()
    mv = request(sock, {"cmd": "move", "session": sid, "azi": 90})
    assert not mv["ok"] and "ended" in mv["error"], mv
    st = request(sock, {"cmd": "stream_stop", "session": sid})
    assert st["ok"], st  # stop after natural end still returns stats


def test_daemon_stream_status(daemon, db, config, castanets, tmp_path):
    """stream_status polls the live position/progress — the feed for in-play
    visualization (reference redraws at ~100 Hz, graphics.cu:352-453)."""
    sock, service = daemon
    src = tmp_path / "st_in.wav"
    write_wav(src, castanets[:6000, None].repeat(2, 1), config.sample_rate)
    out = tmp_path / "st_out.wav"
    resp = request(sock, {"cmd": "stream_start", "input": str(src),
                          "output": str(out), "seconds": 8, "paced": True})
    assert resp["ok"], resp
    try:
        st = request(sock, {"cmd": "stream_status"})
        assert st["ok"] and st["alive"], st
        # default position (0, 0, 0.5) read back through the reference's
        # mirrored cartesian->spherical convention: atan2(-x,-z) -> 180 deg
        # (SoundSource.cu:29; same readback as the move reply)
        assert st["azi"] == 180 and st["r"] == 0.5, st
        assert st["z"] == 0.5, st
        assert st["total_blocks"] == resp["blocks"]
        mv = request(sock, {"cmd": "move", "azi": 90, "ele": 10, "r": 1.0})
        assert mv["ok"], mv
        st = request(sock, {"cmd": "stream_status"})
        assert st["azi"] == 90 and st["ele"] == 10, st
    finally:
        assert request(sock, {"cmd": "stream_stop"})["ok"]
    # status with no session -> clean error
    assert not request(sock, {"cmd": "stream_status"})["ok"]


def test_live_viz_watch(daemon, db, config, castanets, tmp_path):
    """viz.live polls stream_status and redraws the scene SVG while the
    stream plays — the headless analogue of the reference's in-play GLUT
    redraw (graphics.cu:352-453)."""
    from jefferson_tpu.viz.live import watch

    sock, service = daemon
    src = tmp_path / "lv_in.wav"
    write_wav(src, castanets[:6000, None].repeat(2, 1), config.sample_rate)
    out = tmp_path / "lv_out.wav"
    svg = tmp_path / "live.svg"
    resp = request(sock, {"cmd": "stream_start", "input": str(src),
                          "output": str(out), "seconds": 8, "paced": True})
    assert resp["ok"], resp
    try:
        request(sock, {"cmd": "move", "azi": 90, "ele": 0, "r": 1.0})
        status = watch(sock, svg, interval_s=0.01, max_polls=8, three_d=True)
        assert status["ok"], status
        text = svg.read_text()
        assert "listener" in text and "azi 90" in text, text[:400]
        assert svg.with_suffix(".html").exists()  # self-refreshing wrapper
        assert svg.with_suffix(".3d.html").exists()  # perspective live view
        assert svg.with_suffix(".json").exists()
        js = svg.with_suffix(".js").read_text()  # what the 3-D page polls
        assert js.startswith("window.JT3D_STATE = {")
    finally:
        assert request(sock, {"cmd": "stream_stop"})["ok"]
    # after the stream ends, watch exits on the first poll with ok:false
    # (session pruned) — no infinite loop
    status = watch(sock, svg, interval_s=0.01, max_polls=3)
    assert not status.get("ok")


def test_daemon_concurrent_sessions(daemon, db, config, castanets, tmp_path):
    """Two live sessions at once: independent spatializers/outputs; moves
    need an explicit session id while more than one is active."""
    sock, service = daemon
    src = tmp_path / "cc_in.wav"
    write_wav(src, castanets[:6000, None].repeat(2, 1), config.sample_rate)
    o1, o2 = tmp_path / "cc1.wav", tmp_path / "cc2.wav"
    r1 = request(sock, {"cmd": "stream_start", "input": str(src),
                        "output": str(o1), "seconds": 8, "paced": True})
    r2 = request(sock, {"cmd": "stream_start", "input": str(src),
                        "output": str(o2), "seconds": 8, "paced": True})
    assert r1["ok"] and r2["ok"] and r1["session"] != r2["session"]

    ls = request(sock, {"cmd": "stream_list"})
    assert ls["ok"] and set(ls["sessions"]) >= {r1["session"], r2["session"]}

    # ambiguous move must error and name the sessions
    amb = request(sock, {"cmd": "move", "azi": 45})
    assert not amb["ok"] and r1["session"] in amb["error"]
    # explicit session moves land on the right stream
    mv1 = request(sock, {"cmd": "move", "session": r1["session"], "azi": 90})
    mv2 = request(sock, {"cmd": "move", "session": r2["session"], "azi": 270})
    assert mv1["ok"] and mv1["azi"] == 90
    assert mv2["ok"] and mv2["azi"] == 270
    # unknown session id -> clean error
    assert not request(sock, {"cmd": "move", "session": "nope", "azi": 0})["ok"]

    st2 = request(sock, {"cmd": "stream_stop", "session": r2["session"]})
    assert st2["ok"], st2
    # one session left: default resolution works again
    mv = request(sock, {"cmd": "move", "key": "w"})
    assert mv["ok"]
    st1 = request(sock, {"cmd": "stream_stop"})
    assert st1["ok"], st1
    for o in (o1, o2):
        y, sr = read_wav(o)
        assert np.isfinite(y).all()


def test_render_rejects_falsy_zero_fields(daemon, config, castanets, tmp_path):
    """blocks=0 / duration=0 are explicit invalid requests — they must
    error, not be reinterpreted as 'render one pass of the input'."""
    sock, service = daemon
    src = tmp_path / "in0.wav"
    write_wav(src, castanets[:4000], config.sample_rate)
    out = tmp_path / "out0.wav"
    base = {"cmd": "render", "input": str(src), "output": str(out)}
    r = request(sock, {**base, "blocks": 0})
    assert not r["ok"] and "must be positive" in r["error"]
    r = request(sock, {**base, "duration": 0})
    assert not r["ok"] and "must be positive" in r["error"]
    r = request(sock, {**base, "blocks": -3})
    assert not r["ok"] and "must be positive" in r["error"]


def test_render_float_default_bits(daemon, config, castanets, tmp_path):
    """'float': true with no 'bits' writes IEEE float32 (used to raise
    after the render completed)."""
    import struct

    sock, service = daemon
    src = tmp_path / "inf.wav"
    write_wav(src, castanets[:4000], config.sample_rate)
    out = tmp_path / "outf.wav"
    r = request(sock, {"cmd": "render", "input": str(src), "output": str(out),
                       "blocks": 8, "float": True})
    assert r["ok"], r
    fmt_tag, _, _, _, _, bits = struct.unpack_from("<HHIIHH", out.read_bytes(), 20)
    assert fmt_tag == 3 and bits == 32


def test_stream_start_rejects_empty_input(daemon, config, tmp_path):
    """An empty input WAV must be a clean error, not an ok response whose
    stream thread dies silently on the wrapping `% 0` playhead."""
    sock, service = daemon
    src = tmp_path / "empty.wav"
    write_wav(src, np.zeros(0, np.float32), config.sample_rate)
    r = request(sock, {"cmd": "stream_start", "input": str(src),
                       "output": str(tmp_path / "live.wav"), "seconds": 0.1})
    assert not r["ok"] and "is empty" in r["error"]
    assert not service._streams  # nothing half-registered


def test_serve_cli_rejects_bad_chunk_blocks():
    from jefferson_tpu.serve import main

    with pytest.raises(SystemExit, match="positive block count"):
        main(["--chunk-blocks", "0", "--socket", "/tmp/never-bound.sock"])


def test_empty_render_input_rejected(daemon, config, tmp_path):
    sock, service = daemon
    src = tmp_path / "empty2.wav"
    write_wav(src, np.zeros(0, np.float32), config.sample_rate)
    r = request(sock, {"cmd": "render", "input": str(src),
                       "output": str(tmp_path / "o.wav")})
    assert not r["ok"] and "is empty" in r["error"]


def test_stream_start_validates_request(daemon, config, castanets, tmp_path):
    """seconds <= 0 and a stray 'blocks' field are clean errors (the same
    explicit-but-invalid rule render/scene follow) — not an ok response for
    a session that instantly ends."""
    sock, service = daemon
    src = tmp_path / "v_in.wav"
    write_wav(src, castanets[:4000], config.sample_rate)
    out = str(tmp_path / "v_out.wav")
    r = request(sock, {"cmd": "stream_start", "input": str(src),
                       "output": out, "seconds": 0})
    assert not r["ok"] and "seconds" in r["error"]
    r = request(sock, {"cmd": "stream_start", "input": str(src),
                       "output": out, "blocks": 10})
    assert not r["ok"] and "seconds" in r["error"]
    # field validation fires BEFORE the WAV read: with a nonexistent input
    # the reply must still be the 'blocks' complaint, not a file error
    r = request(sock, {"cmd": "stream_start",
                       "input": str(tmp_path / "nonexistent.wav"),
                       "output": out, "blocks": 10})
    assert not r["ok"] and "seconds" in r["error"]


def test_non_object_json_request_gets_clean_error(daemon):
    """Valid JSON that is not an object must get {'ok': false}, not a
    dropped connection (AttributeError in the handler thread)."""
    sock, service = daemon
    for payload in ([1, 2], "x", 3, None):
        r = request(sock, payload)  # request() json-dumps whatever it gets
        assert not r["ok"] and "JSON object" in r["error"], r
    # one level deeper: an object whose cmd is unhashable would raise
    # TypeError in the dict-membership dispatch — same dropped-connection
    # failure mode, same clean-error rule
    for cmd in ([1], {"render": 1}, 3, None):
        r = request(sock, {"cmd": cmd})
        assert not r["ok"] and "cmd must be a string" in r["error"], r


def test_shutdown_not_blocked_by_idle_connection(db, config, tmp_path):
    """A client holding an idle open connection must not hang shutdown:
    server_close() must not join the handler thread blocked in its read
    (block_on_close=False; the handlers are daemons).

    NOTE: only Python 3.10/3.11 can actually fail this — 3.12+ skips
    daemon threads in server_close regardless (gh-104522), so on the CI
    Python this documents the property rather than guarding the attribute;
    the serve.py comment carries the do-not-remove warning."""
    import socket as _socket

    sock = tmp_path / "idle.sock"
    service = RenderService(hrtf_dir=None, chunk_blocks=64)
    t = threading.Thread(target=serve, args=(sock, service), daemon=True)
    t.start()
    for _ in range(200):
        try:
            assert request(sock, {"cmd": "ping"})["pong"]
            break
        except (ConnectionRefusedError, FileNotFoundError, OSError):
            import time

            time.sleep(0.05)
    # idle connection: connect, send nothing, keep it open across shutdown
    idle = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    idle.connect(str(sock))
    try:
        assert request(sock, {"cmd": "shutdown"})["ok"]
        t.join(timeout=5)
        assert not t.is_alive(), "serve() did not return with an idle client"
    finally:
        idle.close()


def test_render_service_devices_must_divide_chunk():
    """Renderer(mesh=...) shards the block axis, so chunk_blocks must split
    evenly over --devices (serve.py's constructor validation)."""
    with pytest.raises(ValueError, match="must divide evenly"):
        RenderService(hrtf_dir=None, chunk_blocks=63, devices=2)
    RenderService(hrtf_dir=None, chunk_blocks=64, devices=2)  # valid


def test_stream_start_capacity_and_shutdown_gates(db, config, castanets, tmp_path):
    """stream_start is refused (cleanly, over the wire) when the daemon is
    at capacity or already shutting down."""
    import time

    from jefferson_tpu.io.wavio import write_wav as _ww

    sock = tmp_path / "gate.sock"
    service = RenderService(hrtf_dir=None, chunk_blocks=64)
    t = threading.Thread(target=serve, args=(sock, service), daemon=True)
    t.start()
    for _ in range(200):
        try:
            assert request(sock, {"cmd": "ping"})["pong"]
            break
        except (ConnectionRefusedError, FileNotFoundError, OSError):
            time.sleep(0.05)
    src = tmp_path / "in.wav"
    _ww(src, castanets[:4096], config.sample_rate)
    try:
        service.max_streams = 0
        r = request(sock, {"cmd": "stream_start", "input": str(src),
                           "output": str(tmp_path / "o1.wav")})
        assert not r["ok"] and "too many active stream sessions" in r["error"]
        service.max_streams = 8

        service._shutting_down = True
        r = request(sock, {"cmd": "stream_start", "input": str(src),
                           "output": str(tmp_path / "o2.wav")})
        assert not r["ok"] and "shutting down" in r["error"]
        service._shutting_down = False
    finally:
        request(sock, {"cmd": "shutdown"})
        t.join(timeout=5)


def test_malformed_json_line_gets_error_not_drop(daemon):
    """A syntactically broken request line gets a clean {'ok': false,
    'bad json'} reply and the CONNECTION SURVIVES for the next request
    (blank lines are skipped, not answered)."""
    import socket as _socket

    sock, service = daemon
    c = _socket.socket(_socket.AF_UNIX, _socket.SOCK_STREAM)
    c.connect(str(sock))
    try:
        f = c.makefile("rwb")
        f.write(b"\n{not json\n")
        f.flush()
        resp = json.loads(f.readline())
        assert not resp["ok"] and "bad json" in resp["error"]
        f.write(json.dumps({"cmd": "ping"}).encode() + b"\n")
        f.flush()
        assert json.loads(f.readline())["pong"]
    finally:
        c.close()


def test_daemon_render_resamples_foreign_rate(daemon, config, castanets, tmp_path):
    """A foreign-rate input WAV is resampled to the engine rate (same rule
    as the CLI), not rendered pitch-shifted."""
    src = tmp_path / "in22k.wav"
    write_wav(src, castanets[:8000], 22050)
    out = tmp_path / "out22k.wav"
    sock, service = daemon
    resp = request(sock, {"cmd": "render", "input": str(src),
                          "output": str(out), "blocks": 16})
    assert resp["ok"], resp
    got, sr = read_wav(out)
    assert sr == config.sample_rate and got.shape == (16 * 128, 2)
    assert np.isfinite(got).all()


def test_daemon_scene_accepts_file_path(daemon, config, castanets, tmp_path):
    """{'cmd': 'scene', 'scene': '<path>'} loads the scene JSON from disk
    (the CLI --scene file convention, available over the wire too)."""
    src = tmp_path / "s.wav"
    write_wav(src, castanets[:8000], config.sample_rate)
    scene_path = tmp_path / "scene.json"
    scene_path.write_text(json.dumps({
        "sources": [{"input": str(src), "trajectory": "static:azi=45"}],
    }))
    out = tmp_path / "scene_out.wav"
    sock, service = daemon
    resp = request(sock, {"cmd": "scene", "scene": str(scene_path),
                          "output": str(out), "blocks": 16})
    assert resp["ok"] and resp["sources"] == 1 and resp["blocks"] == 16, resp
    got, sr = read_wav(out)
    assert sr == config.sample_rate and np.isfinite(got).all()


def test_shutdown_stops_live_sessions_and_reports_pending(db, config, castanets, tmp_path):
    """Shutdown quits live stream sessions (flushed WAVs, listed in
    stopped_sessions) and reports — not claims stopped — a session whose
    thread outlives the 10 s join as pending, with the unflushed warning."""
    import time

    sock = tmp_path / "shut.sock"
    service = RenderService(hrtf_dir=None, chunk_blocks=64)
    t = threading.Thread(target=serve, args=(sock, service), daemon=True)
    t.start()
    for _ in range(200):
        try:
            assert request(sock, {"cmd": "ping"})["pong"]
            break
        except (ConnectionRefusedError, FileNotFoundError, OSError):
            time.sleep(0.05)
    src = tmp_path / "in.wav"
    write_wav(src, castanets[:8192], config.sample_rate)
    out = tmp_path / "live.wav"
    r = request(sock, {"cmd": "stream_start", "input": str(src),
                       "output": str(out), "seconds": 30.0})
    assert r["ok"], r
    sid = r["session"]
    # let the paced loop emit at least one block so the flushed WAV below
    # has content (a quit before block 0 flushes a valid but empty file)
    for _ in range(400):
        st = request(sock, {"cmd": "stream_status", "session": sid})
        if st.get("ok") and st["blocks"] >= 1:
            break
        time.sleep(0.025)
    assert st["blocks"] >= 1, st
    # a stuck session: ignores quit, stays alive through the join window —
    # SHORTENED via the service knob so the suite doesn't block the real
    # 10 s (round-5 test review: the old comment claimed this but nothing
    # was patched)
    service.shutdown_join_s = 0.5

    class _Stuck:
        def __init__(self):
            self.quit = False
    stuck_thread = threading.Thread(target=time.sleep, args=(5.0,), daemon=True)
    stuck_thread.start()
    with service._slock:
        streams = dict(service._streams)
        streams["stuck"] = {**streams[sid], "control": _Stuck(),
                            "thread": stuck_thread}
        service._streams = streams

    resp = request(sock, {"cmd": "shutdown"}, timeout=60.0)
    t.join(timeout=15)
    assert resp["ok"] and resp["shutdown"]
    assert sid in resp["stopped_sessions"], resp
    assert resp.get("pending_sessions") == ["stuck"], resp
    assert "unflushed" in resp.get("warning", ""), resp
    # the real session's writer flushed: a valid, finite WAV on disk
    got, sr = read_wav(out)
    assert sr == config.sample_rate and np.isfinite(got).all() and len(got) > 0


def test_live_viz_cli_main(daemon, db, config, castanets, tmp_path):
    """jefferson-live-viz's entry point: follows a short stream to its end
    (exit 0, artifacts written) and exits 1 with the error printed when no
    session is live."""
    from jefferson_tpu.viz.live import main as live_main

    sock, service = daemon
    src = tmp_path / "lvm_in.wav"
    write_wav(src, castanets[:4000], config.sample_rate)
    out = tmp_path / "lvm_out.wav"
    svg = tmp_path / "lvm.svg"
    resp = request(sock, {"cmd": "stream_start", "input": str(src),
                          "output": str(out), "seconds": 0.25, "paced": True})
    assert resp["ok"], resp
    rc = live_main(["--socket", str(sock), "-o", str(svg),
                    "--session", resp["session"], "--interval", "0.01", "--3d"])
    assert rc == 0
    assert svg.exists() and svg.with_suffix(".3d.html").exists()
    # unknown session: the error path prints the daemon error and returns 1
    rc = live_main(["--socket", str(sock), "-o", str(svg),
                    "--session", "no-such-session", "--interval", "0.01"])
    assert rc == 1


def test_move_dispatch_isolates_handler_exceptions(db, config, monkeypatch):
    """A crash inside the lock-free move/stream_status handlers comes back
    as a typed error response, never a dropped connection."""
    service = RenderService(hrtf_dir=None, chunk_blocks=64)

    def boom(req):
        raise RuntimeError("handler blew up")

    monkeypatch.setattr(service, "_move", boom)
    resp = service.handle({"cmd": "move", "id": 9, "azi": 0, "ele": 0})
    assert resp == {"id": 9, "ok": False, "error": "RuntimeError: handler blew up"}

    monkeypatch.setattr(service, "_stream_start", boom)
    resp2 = service.handle({"cmd": "stream_start"})
    assert resp2["ok"] is False and "handler blew up" in resp2["error"]
    assert service.stats["errors"] >= 1


def test_serve_cli_request_mode(daemon):
    """`jefferson-serve --request` is a one-shot client: prints the JSON
    response and exits 0/1 on ok/error."""
    import io
    from contextlib import redirect_stdout

    from jefferson_tpu.serve import main

    sock, _service = daemon
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(["--socket", str(sock), "--request", '{"cmd": "ping"}'])
    assert rc == 0
    assert json.loads(buf.getvalue())["pong"]

    buf2 = io.StringIO()
    with redirect_stdout(buf2):
        rc2 = main(["--socket", str(sock), "--request", '{"cmd": "definitely-not-a-cmd"}'])
    assert rc2 == 1
    assert "unknown cmd" in json.loads(buf2.getvalue())["error"]


def test_ended_session_stats_survive_unrelated_start(db, config, castanets, tmp_path):
    """A naturally-ended session's stream_stop stats must not depend on
    whether another client started a stream in between (round-5 review:
    stream_start used to evict every ended session), and ended-session
    retention is bounded by max_ended_retained, oldest first."""
    import time

    from jefferson_tpu.io.wavio import write_wav

    service = RenderService(hrtf_dir=None, chunk_blocks=64)
    src = tmp_path / "in.wav"
    write_wav(src, castanets[:6000], config.sample_rate)

    def start(name):
        resp = service.handle({
            "cmd": "stream_start", "input": str(src),
            "output": str(tmp_path / name), "seconds": 0.05, "paced": False,
        })
        assert resp["ok"], resp
        return resp["session"]

    def wait_ended(sid):
        for _ in range(400):
            if not service._streams[sid]["thread"].is_alive():
                return
            time.sleep(0.05)
        raise AssertionError(f"{sid} never ended")

    a = start("a.wav")
    wait_ended(a)
    b = start("b.wav")  # must NOT evict a's ended session
    stop_a = service.handle({"cmd": "stream_stop", "session": a})
    assert stop_a["ok"], stop_a
    assert stop_a["blocks"] > 0 and "avg_ms" in stop_a
    stop_b = service.handle({"cmd": "stream_stop", "session": b})
    assert stop_b["ok"], stop_b

    # retention bound: ended sessions beyond the cap are pruned oldest-first
    service.max_ended_retained = 2
    sids = [start(f"r{i}.wav") for i in range(4)]
    for sid in sids:
        wait_ended(sid)
    trigger = start("trigger.wav")
    retained = set(service._streams) - {trigger}
    assert retained == set(sids[-2:]), retained  # the 2 newest ended stay
    service.handle({"cmd": "stream_stop", "session": trigger})


def test_live_viz_survives_unreachable_daemon(tmp_path, capsys):
    """A daemon shutting down mid-watch (socket unlinked/refused) ends the
    watch with a clean error exit, not a raw traceback (round-5 review)."""
    from jefferson_tpu.viz.live import main as viz_main, watch

    gone = tmp_path / "never-bound.sock"
    status = watch(gone, tmp_path / "live.svg", interval_s=0.01, max_polls=3)
    assert status["ok"] is False and "daemon unreachable" in status["error"]

    rc = viz_main(["--socket", str(gone), "-o", str(tmp_path / "l2.svg")])
    assert rc == 1
    assert "daemon unreachable" in capsys.readouterr().out


def test_daemon_protocol_fuzz_survives_garbage(daemon, config, castanets, tmp_path):
    """200 randomized/malformed requests (wrong types, missing fields,
    unknown commands, junk values in real commands) each get a JSON reply —
    never a dropped connection or a wedged daemon — and a real render still
    works afterwards."""
    import random

    from jefferson_tpu.io.wavio import write_wav

    sock, _service = daemon
    rng = random.Random(4242)
    cmds = ["render", "scene", "stream_start", "stream_stop", "move",
            "stream_status", "stream_list", "stats", "ping", "bogus", "", 7,
            None, ["render"], {"cmd": "render"}]
    junk = [None, -1, 0, 3.5, "x", "", [], {}, {"a": 1}, True, "🎧",
            "/no/such/file.wav", 1e309, "NaN"]
    fields = ["input", "output", "trajectory", "blocks", "duration",
              "seconds", "session", "azi", "ele", "r", "x", "y", "z", "key",
              "bits", "float", "paced", "scene", "chunk_blocks", "id"]
    for i in range(200):
        req = {"cmd": rng.choice(cmds)}
        for _ in range(rng.randint(0, 4)):
            req[rng.choice(fields)] = rng.choice(junk)
        try:
            json.dumps(req)
        except (TypeError, ValueError):
            continue  # unencodable draw; the wire can't carry it anyway
        resp = request(sock, req, timeout=120.0)
        assert isinstance(resp, dict) and "ok" in resp, (i, req, resp)

    # the daemon still serves real work after the abuse
    src = tmp_path / "after.wav"
    write_wav(src, castanets[:4000], config.sample_rate)
    out = tmp_path / "after_out.wav"
    r = request(sock, {"cmd": "render", "input": str(src),
                       "output": str(out), "blocks": 4})
    assert r["ok"], r


def test_serve_cli_daemon_mode_boots_service(tmp_path, monkeypatch, capsys):
    """Daemon-mode main(): enables the compile cache, builds the service
    with the requested chunk size/devices, narrates the socket, and hands
    off to serve() — pinned in-process with serve() stubbed (the live
    socket loop is covered by the daemon fixture and the soak script)."""
    import jefferson_tpu.serve as serve_mod

    seen = {}
    monkeypatch.setattr(
        serve_mod, "serve", lambda sock, svc: seen.update(sock=sock, svc=svc)
    )
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cache"))
    sock = tmp_path / "d.sock"
    rc = serve_mod.main(["--socket", str(sock), "--chunk-blocks", "64"])
    assert rc == 0
    assert f"listening on {sock}" in capsys.readouterr().err
    assert seen["sock"] == str(sock)
    assert isinstance(seen["svc"], serve_mod.RenderService)
    assert seen["svc"].renderer.chunk_blocks == 64
    assert (tmp_path / "cache").is_dir()  # compile cache dir materialized
