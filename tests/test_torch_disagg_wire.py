"""The port's disagg page wire (serving/disagg/wire.py, transport.py)
against the JAX package's, on the CPU.

- frames: every frame type encodes to the JAX ``encode_frame``'s bytes and
  decodes to the same (type, header, payload); truncated, torn, oversized
  and malformed frames raise ``WireError`` with the reference's message;
- pages: a PAGE payload of the same page stacks (numpy leaves on the JAX
  side, torch tensors made of the same bits on the port's; bf16, int8 and
  f32) is the same bytes, and each side decodes the other's payload to the
  same bits — the port without ``ml_dtypes``;
- the handshake: ``pool_geometry`` of a port pool equals the JAX pool's for
  the same model (bf16 and int8 rings), and ``geometry_mismatch`` says the
  same thing about the same pair;
- the schema: ``schema_descriptor()`` equals ``docs/disagg_wire_schema.json``
  and the JAX package's descriptor;
- the transport: exact reads over a socket pair, the length bound checked
  before any allocation, a bounded send queue that blocks (backpressure),
  counts its bytes and latches a dead wire; the injected ``slow_wire`` and
  ``truncated_frame`` faults.
"""

from __future__ import annotations

import ast
import json
import os
import queue
import socket
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_fastapi_k8s_gpu_tpu.parallel import kvpool as jkvpool
from llama_fastapi_k8s_gpu_tpu.serving.disagg import transport as jtransport
from llama_fastapi_k8s_gpu_tpu.serving.disagg import wire as jwire
from llama_fastapi_k8s_gpu_tpu_torch.parallel import kvpool
from llama_fastapi_k8s_gpu_tpu_torch.serving.disagg import transport, wire
from llama_fastapi_k8s_gpu_tpu_torch.utils.faults import FAULTS
from tests.test_torch_kvpool import _cfgs

CPU = torch.device("cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HEADERS = [
    (wire.FRAME_HELLO, {"wire_schema": 2, "page_tokens": 16, "page_bytes": 4096,
                        "leaves": [{"shape": [2, 2, 16, 8], "dtype": "bfloat16"}]}),
    (wire.FRAME_HELLO_OK, {"wire_schema": 2}),
    (wire.FRAME_REQ, {"rid": 3, "namespace": "alpha", "ids": [1, 2, 300],
                      "deadline": 1.5e9, "trace": None}),
    (wire.FRAME_PAGE, {"rid": 3, "seq": 0, "n_pages": 2}),
    (wire.FRAME_DONE, {"rid": 3, "tokens": 32, "n_pages": 2, "first_token": 17}),
    (wire.FRAME_ERR, {"rid": None, "error": "nope é", "code": "geometry"}),
]


def _outcome(fn, *a, **kw):
    try:
        return fn(*a, **kw), None
    except Exception as e:  # noqa: BLE001 — compared across packages
        return None, (type(e).__name__, str(e))


def _page_leaves(seed: int, n_pages: int):
    """The same page stacks as numpy (the JAX side: bf16 through jnp) and as
    torch tensors of the same bits: a bf16 k and v, an int8 k_q and an f32
    k_s."""
    rng = np.random.default_rng(seed)
    shape = (n_pages, 2, 2, 16, 8)
    words = rng.integers(0, 1 << 16, size=shape, dtype=np.uint16)
    words[..., 0] = 0x7FC0                     # a NaN pattern rides as bits
    i8 = rng.integers(-128, 128, size=shape, dtype=np.int8)
    f32 = rng.standard_normal(shape[:-1]).astype(np.float32)
    jleaves = [np.asarray(jnp.asarray(words.view(np.int16)).view(jnp.bfloat16)), i8, f32]
    pleaves = [torch.from_numpy(words.view(np.int16).copy()).view(torch.bfloat16),
               torch.from_numpy(i8.copy()), torch.from_numpy(f32.copy())]
    geometry = {"wire_schema": wire.WIRE_SCHEMA, "page_tokens": 16, "page_bytes": 0,
                "leaves": [{"shape": list(shape[1:]), "dtype": "bfloat16"},
                           {"shape": list(shape[1:]), "dtype": "int8"},
                           {"shape": list(shape[1:-1]), "dtype": "float32"}]}
    return jleaves, pleaves, geometry


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
    a = np.asarray(t)
    return a.view(np.int16) if a.dtype == jnp.bfloat16 else a


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ftype,header", HEADERS, ids=[wire.FRAME_NAMES[f] for f, _ in HEADERS])
@pytest.mark.parametrize("payload", [b"", b"\x00\x01raw page bytes\xff" * 3])
def test_frames_are_the_references_bytes(ftype, header, payload):
    buf = wire.encode_frame(ftype, header, payload)
    assert buf == jwire.encode_frame(ftype, header, payload)
    got = wire.decode_frame(buf[4:])
    assert got == jwire.decode_frame(buf[4:]) == (ftype, header, payload)
    # a memoryview (what the transport hands over) decodes to the same
    f, h, p = wire.decode_frame(memoryview(bytearray(buf[4:])))
    assert (f, h, bytes(p)) == (ftype, header, payload)


BAD_FRAMES = [
    b"",                                            # shorter than the header
    b"\x01\x00\x00",                                # still shorter
    struct.pack("!BI", 9, 2) + b"{}",               # unknown frame type
    struct.pack("!BI", 1, 40) + b"{}",              # header runs past the frame
    struct.pack("!BI", 1, 3) + b"{x}",              # not JSON
    struct.pack("!BI", 1, 2) + b"[]",               # not an object
    struct.pack("!BI", 2, 5) + b"\"abc\"",          # a JSON string
]


@pytest.mark.parametrize("buf", BAD_FRAMES)
def test_malformed_frames_raise_the_references_wire_error(buf):
    got = _outcome(wire.decode_frame, buf)
    want = _outcome(jwire.decode_frame, buf)
    assert got[1][0] == "WireError" and want[1][0] == "WireError"
    assert got[1][1].split(":")[0] == want[1][1].split(":")[0]
    if "JSON" not in got[1][1]:
        assert got == want


def test_unknown_types_and_oversized_frames_are_refused_before_encoding(monkeypatch):
    for mod in (wire, jwire):
        with pytest.raises(mod.WireError, match="unknown frame type 7"):
            mod.encode_frame(7, {})
    monkeypatch.setattr(wire, "MAX_FRAME", 64)
    with pytest.raises(wire.WireError, match="exceeds MAX_FRAME 64"):
        wire.encode_frame(wire.FRAME_PAGE, {"rid": 1}, b"x" * 64)


# ---------------------------------------------------------------------------
# the page payload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_pages", [1, 3, 4])
def test_page_payloads_are_the_references_bytes_both_ways(n_pages):
    jleaves, pleaves, geometry = _page_leaves(n_pages, n_pages)
    payload = wire.encode_pages(pleaves)
    assert payload == jwire.encode_pages(jleaves)
    assert wire.leaf_nbytes(geometry) == jwire.leaf_nbytes(geometry)
    mine = wire.decode_pages(payload, n_pages, geometry)
    theirs = jwire.decode_pages(payload, n_pages, geometry)
    assert [t.dtype for t in mine] == [torch.bfloat16, torch.int8, torch.float32]
    for a, b, src in zip(mine, theirs, pleaves):
        assert tuple(a.shape) == b.shape == tuple(src.shape)
        assert np.array_equal(_bits(a), _bits(b)) and np.array_equal(_bits(a), _bits(src))
    # a writable buffer (the transport's) is viewed in place, not copied
    buf = bytearray(payload)
    view = wire.decode_pages(memoryview(buf), n_pages, geometry)
    buf[0] ^= 0xFF
    assert _bits(view[0]).reshape(-1)[0] != _bits(mine[0]).reshape(-1)[0]


@pytest.mark.parametrize("cut", [-1, 1, 3])
def test_truncated_or_padded_page_payloads_are_refused(cut):
    _, pleaves, geometry = _page_leaves(0, 2)
    payload = wire.encode_pages(pleaves)
    bad = payload[:-cut] if cut > 0 else payload + b"\x00"
    got = _outcome(wire.decode_pages, bad, 2, geometry)
    want = _outcome(jwire.decode_pages, bad, 2, geometry)
    assert got == want and got[1][0] == "WireError"


def test_an_unknown_dtype_in_a_geometry_is_a_wire_error():
    with pytest.raises(wire.WireError, match="unknown dtype 'float7'"):
        wire.leaf_nbytes({"leaves": [{"shape": [1], "dtype": "float7"}]})
    assert wire.decode_pages(b"", 0, _page_leaves(0, 1)[2])[0].shape == (0, 2, 2, 16, 8)


# ---------------------------------------------------------------------------
# the handshake geometry and the pinned schema
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_pool_geometry_equals_the_reference_pools(kv_dtype):
    jcfg, cfg = _cfgs(kv_dtype)
    mine = wire.pool_geometry(kvpool.KVPool(cfg, page_tokens=8, n_pages=4, device=CPU))
    theirs = jwire.pool_geometry(jkvpool.KVPool(jcfg, page_tokens=8, n_pages=4))
    assert mine == theirs
    assert json.dumps(mine) == json.dumps(theirs)
    assert wire.leaf_nbytes(mine) == jwire.leaf_nbytes(theirs)


def test_geometry_mismatch_attribution_equals_the_reference():
    jb, b = _cfgs("bf16")
    _, i8 = _cfgs("int8")
    g_b = wire.pool_geometry(kvpool.KVPool(b, page_tokens=8, n_pages=2, device=CPU))
    g_i8 = wire.pool_geometry(kvpool.KVPool(i8, page_tokens=8, n_pages=2, device=CPU))
    g_t = wire.pool_geometry(kvpool.KVPool(b, page_tokens=16, n_pages=2, device=CPU))
    g_s = {**g_b, "wire_schema": 1}
    for mine, theirs in ((g_b, g_b), (g_b, g_i8), (g_b, g_t), (g_b, g_s), (g_s, g_b)):
        got = wire.geometry_mismatch(mine, theirs)
        assert got == jwire.geometry_mismatch(mine, theirs)
        assert (got is None) == (mine is theirs)
    assert "wire schema mismatch" in wire.geometry_mismatch(g_b, g_s)
    assert "'leaves'" in wire.geometry_mismatch(g_b, g_i8)
    assert "'page_tokens'" in wire.geometry_mismatch(g_b, g_t)


def test_the_schema_equals_the_golden_and_the_references():
    with open(os.path.join(ROOT, "docs", "disagg_wire_schema.json"), encoding="utf-8") as f:
        golden = f.read()
    assert wire.canonical_schema_json() == golden == jwire.canonical_schema_json()
    assert wire.schema_descriptor() == jwire.schema_descriptor()
    assert (wire.WIRE_SCHEMA, wire.MAX_FRAME, wire.PAGE_GROUP) == (2, 1 << 30, 4)
    assert wire.main(["--check-golden"]) == 0


def test_the_check_fails_on_a_drifted_golden(tmp_path, capsys):
    p = tmp_path / "golden.json"
    p.write_text(wire.canonical_schema_json().replace('"wire_schema": 2', '"wire_schema": 3'))
    assert wire.main(["--check-golden", str(p)]) == 1
    assert "DRIFT" in capsys.readouterr().out


def test_the_port_imports_no_ml_dtypes_and_no_numpy_bfloat16():
    pkg = os.path.join(ROOT, "llama_fastapi_k8s_gpu_tpu_torch")
    for root, _, names in os.walk(pkg):
        for n in names:
            if not n.endswith(".py"):
                continue
            path = os.path.join(root, n)
            tree = ast.parse(open(path, encoding="utf-8").read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    assert all(a.name.split(".")[0] != "ml_dtypes" for a in node.names), path
                elif isinstance(node, ast.ImportFrom) and node.module:
                    assert node.module.split(".")[0] != "ml_dtypes", path


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    return transport.FrameConn(a), transport.FrameConn(b)


def test_frames_cross_a_socket_in_order_and_interoperate():
    mine, peer = _pair()
    jpeer = jtransport.FrameConn(peer._sock)
    try:
        _, pleaves, geometry = _page_leaves(1, 3)
        payload = wire.encode_pages(pleaves)
        for ftype, header in HEADERS:
            mine.send_frame(ftype, header, payload if ftype == wire.FRAME_PAGE else b"")
        for ftype, header in HEADERS:
            f, h, p = jpeer.recv_frame()
            assert (f, h) == (ftype, header)
            assert bytes(p) == (payload if ftype == wire.FRAME_PAGE else b"")
        jpeer.send_frame(wire.FRAME_PAGE, {"rid": 1, "seq": 0, "n_pages": 3}, payload)
        f, h, p = mine.recv_frame()
        assert isinstance(p, memoryview) and not p.readonly
        got = wire.decode_pages(p, 3, geometry)
        assert all(np.array_equal(_bits(a), _bits(b)) for a, b in zip(got, pleaves))
    finally:
        mine.close()
        peer.close()


def test_torn_oversized_and_closed_connections():
    mine, peer = _pair()
    buf = wire.encode_frame(wire.FRAME_DONE, {"rid": 1})
    peer._sock.sendall(buf[:len(buf) // 2])
    peer.close()
    with pytest.raises(wire.WireError, match="connection closed mid-frame"):
        mine.recv_frame()
    mine.close()
    mine, peer = _pair()
    peer._sock.sendall(struct.pack("!I", wire.MAX_FRAME + 1))
    with pytest.raises(wire.WireError, match="exceeds MAX_FRAME"):
        mine.recv_frame()
    peer.close()
    with pytest.raises(ConnectionError, match="peer closed"):
        mine.recv_frame()
    mine.close()


def test_send_queue_blocks_counts_and_latches_a_dead_wire():
    a, b = socket.socketpair()
    a.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 4096)
    conn = transport.FrameConn(a)
    sender = transport.FrameSender(conn, max_frames=2)
    big = b"x" * (1 << 20)
    sender.put(wire.FRAME_PAGE, {"rid": 1}, big)       # the sender thread takes it
    sender.put(wire.FRAME_PAGE, {"rid": 1}, big)
    sender.put(wire.FRAME_PAGE, {"rid": 1}, big)
    assert sender.buffered_bytes() >= 2 << 20          # queued, unsent: the ledger's bytes
    with pytest.raises(queue.Full):
        sender.put(wire.FRAME_PAGE, {"rid": 1}, big, timeout=0.2)   # backpressure
    b.close()                                          # the peer dies
    deadline = time.time() + 10
    err = None
    while time.time() < deadline and err is None:
        try:
            sender.put(wire.FRAME_DONE, {"rid": 1}, timeout=0.2)
        except queue.Full:
            continue
        except OSError as e:
            err = e
    assert isinstance(err, OSError)                    # latched: every put raises now
    with pytest.raises(OSError):
        sender.put(wire.FRAME_DONE, {"rid": 2})
    assert sender.buffered_bytes() == 0
    sender.close(join_timeout=1)


def test_injected_slow_and_truncated_frames():
    mine, peer = _pair()
    try:
        FAULTS.arm("slow_wire:slow:delay=0.3")
        t0 = time.time()
        mine.send_frame(wire.FRAME_HELLO_OK, {"wire_schema": 2})
        assert time.time() - t0 >= 0.3
        assert peer.recv_frame()[0] == wire.FRAME_HELLO_OK
        FAULTS.arm("truncated_frame:error")
        with pytest.raises(wire.WireError, match="truncated frame injected"):
            mine.send_frame(wire.FRAME_DONE, {"rid": 1, "tokens": 0})
        with pytest.raises(wire.WireError, match="connection closed mid-frame"):
            peer.recv_frame()
    finally:
        FAULTS.disarm()
        peer.close()


def test_connect_dials_a_listening_service():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    got = {}

    def accept():
        s, _ = srv.accept()
        got["frame"] = transport.FrameConn(s).recv_frame()
        s.close()

    th = threading.Thread(target=accept)
    th.start()
    conn = transport.connect("127.0.0.1", srv.getsockname()[1], timeout=5)
    conn.send_frame(wire.FRAME_HELLO_OK, {"wire_schema": 2})
    th.join(5)
    conn.close()
    srv.close()
    assert got["frame"][:2] == (wire.FRAME_HELLO_OK, {"wire_schema": 2})
