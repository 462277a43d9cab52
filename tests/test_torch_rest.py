"""The port's REST server (``xapiand_tpu_torch/server/``) on the CPU:
every case of ``tests/test_rest.py`` that needs no mesh or cluster, run
against the port's server in a thread with ``device="cpu"`` (where every
kernel wrapper runs its plain version); the conformance replay of
``docs/EXAMPLES.md`` against it; and the same requests sent to the JAX
server and to the port's, their answers compared with the volatile fields
skipped as ``scripts/conformance.py subset_match`` skips them. Nothing is
timed."""

import asyncio
import importlib.util
import json
import os
import time

import pytest
import torch

import test_rest as jr
from xapiand_tpu_torch.server.app import IndexManager, create_app

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the cases of tests/test_rest.py that take the module's server, in the
# file's order (later cases read indexes earlier ones wrote); the two that
# start servers of their own (autocommit, admin) are mirrored below
SRV_CASES = [n for n in vars(jr) if n.startswith("test_") and
             n not in ("test_autocommit_debouncer",
                       "test_admin_flush_and_quit")]
# docs/EXAMPLES.md's /sharded cases: num_shards > 1, the port's
# ShardedDatabase (parallel/sharded_db.py)
MESH_PATH = "/sharded/"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    torch.set_num_threads(1)


class PortServer(jr.ServerThread):
    """tests/test_rest.py's in-process server, with the port's app and an
    IndexManager on the CPU."""

    def _run(self):
        from aiohttp import web

        async def start():
            app = create_app(manager=IndexManager(
                self.data_dir, device="cpu", **self.manager_opts),
                cluster_config=self.cluster_config,
                server_opts=self.server_opts)
            self.server = app["server"]
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", self.http_port)
            await site.start()
            self.port = runner.addresses[0][1]
            self._runner = runner
            self._started.set()

        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(start())
        self._loop.run_forever()


@pytest.fixture(scope="module")
def srv(tmp_path_factory):
    s = PortServer(str(tmp_path_factory.mktemp("port-rest-data")))
    yield s
    s.stop()


def _conformance():
    spec = importlib.util.spec_from_file_location(
        "conformance", os.path.join(ROOT, "scripts", "conformance.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("case", SRV_CASES)
def test_rest_case_on_the_port(srv, case):
    """tests/test_rest.py's case, its body unchanged, against the port."""
    getattr(jr, case)(srv)


def test_autocommit_debouncer_on_the_port(tmp_path):
    """test_rest.py::test_autocommit_debouncer: writes without ?commit
    become searchable after the committer's debounce fires."""
    s = PortServer(str(tmp_path / "auto"),
                   manager_opts={"autocommit_s": 0.2,
                                 "autocommit_force_s": 0.6})
    try:
        s.req("PUT", "/auto/1", {"body": "lazy commit"})   # no ?commit
        deadline = time.time() + 10
        total = 0
        while time.time() < deadline:
            _st, out, _ = s.req("POST", "/auto/:search",
                                {"_query": {"body": "lazy"}})
            total = out.get("total", 0)
            if total:
                break
            time.sleep(0.1)
        assert total == 1, "autocommit never fired"
        _st, info, _ = s.req("GET", "/auto/:info")
        assert info["revision"] >= 1
    finally:
        s.stop()


def test_admin_flush_and_quit_on_the_port(tmp_path):
    """test_rest.py::test_admin_flush_and_quit on the port's server."""
    s = PortServer(str(tmp_path / "admin"),
                   server_opts={"admin_commands": True})
    try:
        s.req("PUT", "/adm/1", {"body": "hello flush"})
        status, out, _ = s.req("FLUSH", "/")
        assert status == 200 and out["#databases_flushed"] >= 1
        status, doc, _ = s.req("GET", "/adm/1")
        assert status == 200 and doc["body"] == "hello flush"
        status, _, _ = s.req("QUIT", "/adm/")
        assert status == 405
        fired = []
        s.server.on_quit = lambda: fired.append(True)
        status, out, _ = s.req("QUIT", "/")
        assert status == 200 and out["#quit"] is True
        deadline = time.time() + 5
        while not fired and time.time() < deadline:
            time.sleep(0.05)
        assert fired
    finally:
        s.stop()


def test_server_info_names_the_torch_device(srv):
    """GET / answers its devices from torch, not jax."""
    status, out, _ = srv.req("GET", "/")
    assert status == 200 and out["devices"] == ["cpu"]


@pytest.mark.parametrize("cuts", [(), (1,), (7, 8, 50, 51), (3, 4, 5, 6),
                                  "every byte"])
def test_ndjson_lines_any_chunking(cuts):
    """ndjson_lines gives the same non-blank lines, in order, however the
    body is cut into chunks: inside a line, at a newline, between two
    newlines, one byte a chunk; a last line without a newline."""
    from xapiand_tpu_torch.server.app import ndjson_lines

    body = b'{"a": 1}\n\n  \n{"b": [2, 3]}\n{"c": "x\\ny"}\n{"d": 4}'
    want = [ln for ln in body.split(b"\n") if ln.strip()]
    if cuts == "every byte":
        cuts = tuple(range(1, len(body)))
    edges = [0, *cuts, len(body)]

    async def chunks():
        for a, b in zip(edges, edges[1:]):
            yield body[a:b]

    async def lines():
        return [ln async for ln in ndjson_lines(chunks())]

    assert asyncio.run(lines()) == want
    assert [json.loads(ln) for ln in want] == [
        {"a": 1}, {"b": [2, 3]}, {"c": "x\ny"}, {"d": 4}]


def test_restore_ndjson_lines_cut_across_chunks(srv):
    """POST :restore reads an NDJSON body that arrives in pieces cutting
    lines in two, with a blank line and no newline after the last line:
    every document indexed once and whole."""
    lines = [json.dumps({"_id": f"c{i}", "body": f"piece {i} word{i % 3}"})
             for i in range(30)]
    body = ("\n".join(lines[:10]) + "\n\n" + "\n".join(lines[10:])).encode()
    cuts = [0, 7, 8, 50, 51, 200, 333, len(body) - 3, len(body)]

    def pieces():
        for a, b in zip(cuts, cuts[1:]):
            time.sleep(0.02)
            yield body[a:b]

    status, out, _ = srv.req("POST", "/chunked/:restore", pieces(),
                             headers={"Content-Type":
                                      "application/x-ndjson"})
    assert status == 200 and out["#indexed"] == 30, out
    status, out, _ = srv.req("POST", "/chunked/:count",
                             {"_query": {"body": "piece"}})
    assert out["count"] == 30
    status, out, _ = srv.req("POST", "/chunked/:count",
                             {"_query": {"body": "word2"}})
    assert out["count"] == 10
    status, out, _ = srv.req("GET", "/chunked/c29")
    assert status == 200 and out["body"] == "piece 29 word2", out


def test_mesh_and_cluster_refused_by_name(srv, tmp_path):
    """num_shards > 1 opens the port's ShardedDatabase (the mesh plane is
    ported): a write and a search answer, and :info reports the shards; a
    manager with more default shards opens; cluster mode alone still
    raises by name."""
    from xapiand_tpu_torch.parallel.sharded_db import ShardedDatabase

    srv.req("PUT", "/meshy/:settings", {"num_shards": 2})
    status, out, _ = srv.req("PUT", "/meshy/1?commit", {"body": "x"})
    assert status == 200 and out["_id"] == "1"
    status, out, _ = srv.req("POST", "/meshy/:search",
                             {"_query": {"body": "x"}})
    assert status == 200 and out["total"] == 1
    status, out, _ = srv.req("GET", "/meshy/:info")
    assert out["num_shards"] == 2 and out["mesh"] == {"dp": 1, "shard": 2}
    man = IndexManager(str(tmp_path / "m"), default_num_shards=2,
                       device="cpu")
    assert isinstance(man.get("idx", create=True), ShardedDatabase)
    man.close()
    with pytest.raises(NotImplementedError, match="cluster mode"):
        create_app(manager=IndexManager(None, device="cpu"),
                   cluster_config={"name": "n", "port": 1,
                                   "http_port": 2})


def test_index_manager_runs_on_the_card_unless_told():
    """IndexManager, like Database, takes the card by default and raises
    without one."""
    if torch.cuda.is_available():
        assert IndexManager(None).device == torch.device("cuda")
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            IndexManager(None)
    assert IndexManager(None, device="cpu").device == torch.device("cpu")


def test_conformance_replay_on_the_port(tmp_path):
    """scripts/conformance.py's replay of docs/EXAMPLES.md against a fresh
    port server: every case passes, the four mesh cases (a 2-shard index:
    settings, a write, a search, the reshard refused) among them."""
    conf = _conformance()
    cases = conf.parse_spec(os.path.join(ROOT, "docs", "EXAMPLES.md"))
    mesh = [c for c in cases if c["path"].startswith(MESH_PATH)]
    rest = [c for c in cases if not c["path"].startswith(MESH_PATH)]
    assert len(rest) >= 50 and len(mesh) == 4
    s = PortServer(str(tmp_path / "conf"))
    try:
        url = f"http://127.0.0.1:{s.port}"
        assert conf.replay(url, cases) == 0
    finally:
        s.stop()


def _answers(server, cases):
    """(status, JSON body or None) of each case, sent in order."""
    out = []
    for c in cases:
        body = None
        headers = {}
        if c["body_text"] is not None:
            body = c["body_text"].encode() if c["body_raw"] else \
                json.dumps(json.loads(c["body_text"])).encode()
            headers["Content-Type"] = c["content_type"] or \
                ("application/json" if not c["body_raw"] else "")
        status, payload, ct = server.req(c["method"], c["path"], body,
                                         headers=headers, raw=True)
        try:
            out.append((status, json.loads(payload) if "json" in ct
                        else None))
        except ValueError:
            out.append((status, None))
    return out


def test_port_answers_as_the_jax_server(tmp_path):
    """docs/EXAMPLES.md's requests, the mesh's among them, in order, to a
    JAX server and to a port server: the same statuses, and each JSON
    answer covers the other (conformance.subset_match both ways: #took and
    uuid skipped, floats within 1e-6 of max(1, |x|))."""
    conf = _conformance()
    cases = conf.parse_spec(os.path.join(ROOT, "docs", "EXAMPLES.md"))
    js = jr.ServerThread(str(tmp_path / "jax"))
    ps = PortServer(str(tmp_path / "port"))
    try:
        want = _answers(js, cases)
        got = _answers(ps, cases)
    finally:
        js.stop()
        ps.stop()
    # beyond #took and uuid, what differs by design: the clock, the device
    # names (app.py's docstring), the ids a POST without one generates
    # (uuid4), and each server's data dir
    subs = {str(tmp_path / "jax"): str(tmp_path / "port")}
    bad = []
    for c, (gs, gb), (ws, wb) in zip(cases, got, want):
        if c["method"] == "POST" and isinstance(wb, dict) and "_id" in wb \
                and "_id" not in json.loads(c["body_text"] or "{}"):
            subs[wb["_id"]] = gb["_id"]
        wb, gb = _volatile_out(wb, subs), _volatile_out(gb, {})
        err = None
        if gs != ws:
            err = f"status {gs} != {ws}"
        elif wb is not None or gb is not None:
            err = conf.subset_match(wb, gb) or conf.subset_match(gb, wb)
        if err:
            bad.append(f"{c['method']} {c['path']}: {err}")
    assert not bad, "\n".join(bad)


def _volatile_out(body, subs):
    """body without "uptime" and "devices", each string that starts with
    a key of subs starting with its value instead."""
    if isinstance(body, dict):
        return {k: _volatile_out(v, subs) for k, v in body.items()
                if k not in ("uptime", "devices")}
    if isinstance(body, list):
        return [_volatile_out(v, subs) for v in body]
    if isinstance(body, str):
        for a, b in subs.items():
            if body.startswith(a):
                return b + body[len(a):]
    return body
