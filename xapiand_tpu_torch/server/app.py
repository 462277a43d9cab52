"""The REST application: index/document CRUD, search, admin views.

Reference parity target: src/server/http_client.cc - the dispatch table
(1034-1219) and views (http_client.h:321-351): document CRUD + PATCH/
UPDATE/STORE, SEARCH/COUNT, INFO, METADATA, COMMIT, DUMP/RESTORE, CHECK,
WAL, :metrics, plus command-style paths (``GET /idx/:search``,
http_client.cc:1013-1032). Custom verbs (SEARCH, COUNT, ...) are accepted
as well as their command-path forms.

Per-request timing lands in the response (#took) and in Prometheus
summaries (xapiand_operations_summary analog, src/metrics.cc).

The torch port's copy of ``xapiand_tpu/server/app.py``: the JAX file with
its imports pointed at the port, and these differences alone
(``tests/test_torch_import.py`` holds the file to them):

- ``_server_info`` answers ``devices`` from torch, not ``jax.devices()``.
- ``IndexManager`` takes a ``device`` (None: the card, and without a card
  it raises, as ``Database()`` does) and opens each ``Database`` on it.
- ``num_shards > 1`` opens the port's ``ShardedDatabase`` on that device
  (every shard stacked on it).
- ``cluster_config`` (``parallel/cluster.py``, ``parallel/replication.py``)
  is refused by name: cluster mode is ROADMAP later work.
- ``:restore`` splits an NDJSON body a chunk at a time (``ndjson_lines``),
  not a line at a time, which was quadratic in the body's size.
"""

from __future__ import annotations

import asyncio
import os
import re
import time
from typing import Optional

from aiohttp import web

from xapiand_tpu_torch import __version__
from xapiand_tpu_torch.database import (Database, DocumentNotFound,
                                  VersionConflict, _device)
from xapiand_tpu_torch.query.dsl import QueryDSL, QueryDSLError, parse_sort
from xapiand_tpu_torch.server import negotiation as neg
from xapiand_tpu_torch.utils.patcher import PatchError, apply_patch

try:
    from prometheus_client import (CollectorRegistry, Counter, Summary,
                                   generate_latest)
except ImportError:  # pragma: no cover
    CollectorRegistry = None

_SAFE_SEG = re.compile(r"^[\w.\-]+$", re.UNICODE)

CUSTOM_METHODS = ("SEARCH", "COUNT", "INFO", "COMMIT", "DUMP", "RESTORE",
                  "CHECK", "UPDATE", "UPSERT", "MERGE", "STORE", "OPEN",
                  "CLOSE", "FLUSH", "QUIT")

_MISSING = object()   # "_data absent" sentinel (None means erase)

_MESH_REFUSAL = ("not ported yet: cluster mode (parallel/cluster.py, "
                 "parallel/replication.py; ROADMAP later work)")


class ApiError(web.HTTPException):
    def __init__(self, status: int, message: str):
        self.status_code = status
        super().__init__(text=message)


class IndexManager:
    """Open-index registry (DatabasePool/XapiandManager-lite for one node).

    Per-index settings (≙ IndexSettings persisted in `.xapiand/indices`,
    src/index_resolver_lru.h:41-66): ``num_shards`` selects the mesh-backed
    ShardedDatabase behind every REST route; defaults come from the server
    flags (≙ opts.h:85-86 num_shards/num_replicas defaults). Settings are
    fixed at index creation - resharding needs dump/restore, matching the
    reference (index settings are created on first write and immutable)."""

    def __init__(self, data_dir: Optional[str] = None, scheme: str = "bm25",
                 default_num_shards: int = 1,
                 autocommit_s: float = 1.0, autocommit_force_s: float = 3.0,
                 pool_size: int = 10, num_doc_preparers: Optional[int] = None,
                 default_num_replicas: int = 0, device=None):
        self.device = _device(device)
        self.data_dir = data_dir
        self.scheme = scheme
        self.default_num_shards = int(default_num_shards)
        # ≙ opts.h:77 database_pool_size (LRU of open databases) and
        # opts.h:71 num_doc_preparers (bulk prepare pool width)
        self.pool_size = max(int(pool_size), 1)
        self.num_doc_preparers = num_doc_preparers
        self.default_num_replicas = int(default_num_replicas)
        self.post_open = None          # hook: (name, db) -> None
        self.indexes: dict[str, Database] = {}
        self.settings: dict[str, dict] = {}
        # autocommit debouncer (≙ the reference committer, handler.h:398-401
        # via debouncer.h; defaults opts.h:111-114 = 1s debounce): writes
        # without ?commit still become searchable shortly after the burst
        self.commit_runner = None      # hook: post fn onto the serving loop
        self._committer = None
        if autocommit_s and autocommit_s > 0:
            from xapiand_tpu_torch.utils.debouncer import Debouncer

            self._committer = Debouncer(self._autocommit,
                                        debounce_s=autocommit_s,
                                        max_force_s=autocommit_force_s)
        if data_dir:
            os.makedirs(data_dir, exist_ok=True)
            for name in sorted(os.listdir(data_dir)):
                if os.path.isdir(os.path.join(data_dir, name, "wal")):
                    self.indexes[name.replace("%2F", "/")] = None  # lazy

    def _path_for(self, name: str) -> Optional[str]:
        if self.data_dir is None:
            return None
        return os.path.join(self.data_dir, name.replace("/", "%2F"))

    def validate(self, name: str):
        for seg in name.split("/"):
            if not seg or not _SAFE_SEG.match(seg) or seg.startswith(":"):
                raise ApiError(400, f"invalid index name {name!r}")

    # -- per-index settings (num_shards; resolver analog) ----------------------

    def get_settings(self, name: str) -> dict:
        s = self.settings.get(name)
        if s is not None:
            return s
        path = self._path_for(name)
        if path is not None:
            import json as _json

            fp = os.path.join(path, "settings.json")
            if os.path.exists(fp):
                with open(fp) as fh:
                    s = _json.load(fh)
                self.settings[name] = s
                return s
        s = {"num_shards": self.default_num_shards}
        self.settings[name] = s
        return s

    def set_settings(self, name: str, new: dict) -> dict:
        self.validate(name)
        if not isinstance(new, dict):
            raise ApiError(400, "settings body must be an object")
        ns = new.get("num_shards", self.default_num_shards)
        if not isinstance(ns, int) or not (1 <= ns <= 256):
            raise ApiError(400, "num_shards must be an int in [1, 256]")
        cur = self.indexes.get(name)
        if cur is None and name in self.indexes and \
                self.get_settings(name).get("num_shards") != ns:
            # lazily-closed on-disk index: reopen to check emptiness, else
            # resharding a non-empty index would slip through unchecked
            cur = self.get(name)
        if cur is not None and cur.doc_count + len(cur._builder) > 0 \
                and self.get_settings(name).get("num_shards") != ns:
            raise ApiError(400,
                           f"index {name!r} already has documents; "
                           "num_shards is fixed at creation "
                           "(dump + restore into a new index to reshard)")
        s = {"num_shards": ns}
        for k in ("num_replicas",):
            if k in new:
                s[k] = int(new[k])
        if "prefix_cap" in new:
            pc = new["prefix_cap"]
            if not isinstance(pc, int) or pc < 0 or \
                    (pc and (pc & (pc - 1) or pc < 128)):
                raise ApiError(400, "prefix_cap must be 0 (off) or a "
                                    "power of two >= 128")
            s["prefix_cap"] = pc
        self.settings[name] = s
        path = self._path_for(name)
        if path is not None:
            import json as _json

            os.makedirs(path, exist_ok=True)
            with open(os.path.join(path, "settings.json"), "w") as fh:
                _json.dump(s, fh)
        if cur is not None and cur.doc_count + len(cur._builder) == 0 and \
                getattr(cur, "n_shards", 1) != ns:
            # empty index: rebuild the backend with the new shard count
            cur.close()
            self.indexes.pop(name, None)
        return s

    def _open(self, name: str) -> Database:
        s = self.get_settings(name)
        n_shards = int(s.get("num_shards", 1))
        if n_shards > 1:
            from xapiand_tpu_torch.parallel.sharded_db import ShardedDatabase

            db = ShardedDatabase(path=self._path_for(name),
                                 scheme=self.scheme, n_shards=n_shards,
                                 device=self.device)
        else:
            db = Database(path=self._path_for(name), scheme=self.scheme,
                          device=self.device)
        # impact-prefix pruning on the batched serving path (maxweight
        # analog, matcher.cc:415): certified-exact top-k, counts become
        # lower bounds on pruned queries. Default ON at 8192 (chip A/B
        # 2026-08-18: 16,532 QPS vs 11,247 unpruned, 34/1024 re-runs);
        # only terms with > cap postings are pruned, so small indexes
        # are bit-identical. prefix_cap=0 in settings turns it off.
        db.prefix_cap = int(s.get("prefix_cap", 8192))
        return db

    def get(self, name: str, create: bool = False) -> Database:
        self.validate(name)
        db = self.indexes.get(name)
        if db is None:
            if name not in self.indexes and not create and \
                    name not in self.settings:
                raise ApiError(404, f"index {name!r} not found")
            db = self._open(name)
            self.indexes[name] = db
            self._resolve_foreign(name, db)
            if self.post_open is not None:
                self.post_open(name, db)
            self._evict_lru()
        else:
            # LRU touch: dicts iterate in insertion order
            self.indexes.pop(name)
            self.indexes[name] = db
        return db

    def apply_schema(self, name: str, body: dict) -> dict:
        """``PUT /idx/ {"_schema": ...}``: explicit schema creation.

        A root ``_type: "foreign/..."`` + ``_foreign: "<index>/<doc_id>"``
        stores/loads the schema as a shared document in the other index
        (foreign-schemas.md; the reference keeps them in `.xapiand/indices`
        or a user index). Non-foreign bodies replace the schema inline."""
        if not isinstance(body, dict):
            raise ApiError(400, "_schema must be an object")
        db = self.get(name, create=True)
        fields = {k: v for k, v in body.items()
                  if k not in ("_type", "_foreign", "_endpoint")}
        if str(body.get("_type", "")).startswith("foreign"):
            endpoint = body.get("_foreign")
            if not isinstance(endpoint, str) or "/" not in endpoint:
                raise ApiError(400, "_foreign must be '<index>/<doc_id>'")
            self._bind_foreign(name, db, endpoint, fields)
        else:
            db.set_schema_props(fields)
        return db.schema.to_dict()

    def _bind_foreign(self, name: str, db: Database, endpoint: str,
                      fields: dict):
        fidx, fdoc = endpoint.rsplit("/", 1)
        if fidx == name:
            raise ApiError(400, "foreign schema endpoint must be "
                                "a different index")
        fdb = self.get(fidx, create=True)
        try:
            shared = fdb.get_document(fdoc).get("_schema_props") or {}
        except DocumentNotFound:
            shared = fields
            # _-prefixed root field is data-only: the schema document is
            # stored verbatim, nothing of it is term-indexed
            fdb.index_document({"_schema_props": shared}, doc_id=fdoc,
                               commit=True)

        def writeback(props, _mgr=self, _fidx=fidx, _fdoc=fdoc):
            # resolve the owning index at WRITE time: capturing the
            # Database object would write through a closed WAL (or a
            # stale instance) after an LRU eviction/reopen (_evict_lru)
            _mgr.get(_fidx, create=True).index_document(
                {"_schema_props": {k: v for k, v in props.items()
                                   if k != "_foreign"}},
                doc_id=_fdoc, commit=True)

        db.bind_foreign_schema(endpoint, shared, writeback)

    def _resolve_foreign(self, name: str, db: Database):
        """Reopen path: a persisted root `_foreign` pointer re-adopts the
        shared schema document (fresh copy) + write-back hook."""
        try:
            endpoint = db.schema.props.get("schema", {}).get("_foreign")
        except Exception:
            return
        if isinstance(endpoint, str) and "/" in endpoint:
            fields = {k: v for k, v in
                      db.schema.props["schema"].items() if k != "_foreign"}
            self._bind_foreign(name, db, endpoint, fields)

    def _evict_lru(self):
        """Close least-recently-used databases over pool_size (≙ the
        reference database pool checkin/checkout LRU, pool.cc). The name
        stays mapped (lazily None) so the index remains discoverable and
        reopens on demand."""
        open_names = [n for n, d in self.indexes.items() if d is not None]
        while len(open_names) > self.pool_size:
            oldest = open_names.pop(0)
            self.flush_one(oldest)

    def flush_one(self, name: str) -> bool:
        """Commit + close one open database; it reopens lazily on the next
        access (one unit of database_pool->cleanup, http_client.cc:1176)."""
        db = self.indexes.get(name)
        if db is None or db.path is None:
            return False   # in-memory databases cannot lazily reopen
        try:
            db.commit()
        except Exception:
            pass
        db.close()
        self.indexes[name] = None
        return True

    def exists(self, name: str) -> bool:
        return name in self.indexes

    def delete(self, name: str):
        db = self.indexes.pop(name, None)
        self.settings.pop(name, None)
        if db is None:
            raise ApiError(404, f"index {name!r} not found")
        db.close()
        path = self._path_for(name)
        if path and os.path.isdir(path):
            import shutil

            shutil.rmtree(path)

    def touch(self, name: str):
        """Arm the autocommit debouncer after an uncommitted write."""
        if self._committer is not None:
            self._committer.trigger(name)

    def _autocommit(self, name: str):
        db = self.indexes.get(name)
        if db is None:
            return
        def run():
            if len(db._builder) or db._pending_deletes:
                db.commit()
        if self.commit_runner is not None:
            # serialize with request handling (single-writer discipline):
            # the server routes this through the worker pool under the
            # index's exclusive lock
            self.commit_runner(run, name)
        else:
            run()

    def flush_autocommit(self):
        if self._committer is not None:
            self._committer.flush()

    def close(self):
        if self._committer is not None:
            self._committer.close()
        for db in self.indexes.values():
            if db is not None:
                db.close()


def parse_path(path: str):
    """'/a/b/:search' -> ('a/b', None, 'search'); '/a/b/1' -> ('a/b','1',None).

    ≙ PathParser (src/url_parser.h:68-102) minus drill selectors."""
    parts = [p for p in path.split("/") if p]
    cmd = None
    if parts and parts[-1].startswith(":"):
        cmd = parts[-1][1:].lower()
        parts = parts[:-1]
    return "/".join(parts), cmd


class SearchBatcher:
    """Request micro-batcher: concurrent plain searches on one index
    coalesce into Database.search_many calls (device batch width instead
    of serialized ~2ms launches - the TPU answer to the reference's
    http-client thread pool, manager.h:155-163).

    Leader/follower inside the existing worker pool: the first arriving
    thread becomes leader, sleeps the batching window collecting
    followers, then executes one search_many per (k, offset, scheme)
    group and distributes results. Followers block on an event; the
    leader's finally-block guarantees every event fires."""

    def __init__(self, window_s: float = 0.002, max_batch: int = 256):
        import threading

        self.window_s = window_s
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._pending: list = []
        self._has_leader = False
        # adaptive window: a lone client should not pay the coalescing
        # sleep - only wait when concurrency was actually seen recently
        self._last_multi = 0.0

    def run(self, get_db, ir, k: int, offset: int, scheme):
        import threading

        item = {"ir": ir, "k": k, "offset": offset, "scheme": scheme,
                "ev": threading.Event(), "res": None, "err": None}
        with self._lock:
            self._pending.append(item)
            lead = not self._has_leader
            if lead:
                self._has_leader = True
        if not lead:
            item["ev"].wait()
            if item["err"] is not None:
                raise item["err"]
            if item["res"] is None:   # leader died via BaseException
                raise ApiError(503, "search batch leader aborted")
            return item["res"]
        if self.window_s > 0 and time.time() - self._last_multi < 1.0:
            time.sleep(self.window_s)
        while True:   # the leader drains bursts > max_batch itself:
            #           followers are blocked and cannot self-promote
            with self._lock:
                batch = self._pending[: self.max_batch]
                self._pending = self._pending[self.max_batch:]
                if not batch:
                    self._has_leader = False
                    break
                if len(batch) > 1:
                    self._last_multi = time.time()
            try:
                groups: dict = {}
                for it in batch:
                    key = (it["k"], it["offset"],
                           it["scheme"].key() if it["scheme"] is not None
                           else None)
                    groups.setdefault(key, []).append(it)
                db = get_db()
                for (k_g, off_g, _sk), items in groups.items():
                    try:
                        if len(items) == 1:   # lone query: the plain
                            # per-query path (no batch padding/planning)
                            items[0]["res"] = db.search(
                                items[0]["ir"], k=k_g, offset=off_g,
                                scheme=items[0]["scheme"])
                            continue
                        outs = db.search_many([it["ir"] for it in items],
                                              k=k_g, offset=off_g,
                                              scheme=items[0]["scheme"])
                        for it, res in zip(items, outs):
                            it["res"] = res
                    except Exception as exc:   # propagate to the group
                        for it in items:
                            it["err"] = exc
            except Exception as exc:   # get_db() etc.: fail the batch
                for it in batch:
                    if it["err"] is None and it["res"] is None:
                        it["err"] = exc
            finally:
                for it in batch:
                    if it is not item:
                        it["ev"].set()
        if item["err"] is not None:
            raise item["err"]
        return item["res"]


class RestServer:
    def __init__(self, manager: IndexManager, cluster=None, replicator=None,
                 server_opts: Optional[dict] = None):
        import threading
        from concurrent.futures import ThreadPoolExecutor

        # response-shaping defaults (≙ opts.h:40-47 pretty/echo/human/
        # comments flags); per-request ?pretty still overrides
        # num_http_clients: unlike the reference's GIL-free C++ worker
        # threads (opts.h:67 default 8), extra Python pool workers on
        # few cores only add GIL churn - measured mix @8 clients on
        # 1 core: pool 8 -> 378 qps p99 130ms, pool 2 -> 502 qps p99
        # 37ms. Scale with the host, cap at the reference's default.
        import os as _os
        self.opts = {"pretty": False, "comments": True, "echo": False,
                     "human": False, "cluster_name": "xapiand-tpu",
                     "num_http_clients": max(2, min(8, _os.cpu_count()
                                                    or 2)),
                     "admin_commands": False,
                     "search_batch_window": 0.002}
        if server_opts:
            self.opts.update(server_opts)
        # QUIT wiring: __main__ sets this to a SIGTERM-to-self so
        # web.run_app shuts down gracefully; embedded servers leave it None
        self.on_quit = None
        self.man = manager
        self.cluster = cluster
        self.replicator = replicator
        self.started = time.time()
        # device execution and bulk indexing run in this worker pool so a
        # slow query (or a first-compile of a new shape) never stalls the
        # event loop - /:metrics and other requests keep flowing
        # (≙ the reference's N http clients over a database pool,
        # manager.h:155-163, opts.h num_http_clients). Per-index RW lock:
        # concurrent searches, single writer (Xapian's reader/writer
        # discipline per shard).
        self.pool = ThreadPoolExecutor(
            max_workers=max(int(self.opts["num_http_clients"]), 1),
            thread_name_prefix="xapiand-http")
        self._locks: dict = {}
        self._locks_guard = threading.Lock()
        self._batchers: dict = {}   # index -> SearchBatcher (plain queries)
        self._ir_cache: dict = {}   # (index, query, schema/rev) -> parsed IR
        self._active_searches = 0   # in-flight :search handlers (loop-owned)
        if CollectorRegistry is not None:
            self.registry = CollectorRegistry()
            self.op_count = Counter(
                "xapiand_operations_total", "operations",
                ["operation"], registry=self.registry)
            self.op_summary = Summary(
                "xapiand_operations_summary", "operation seconds",
                ["operation"], registry=self.registry)
        else:  # pragma: no cover
            self.registry = None

    def _lock_for(self, index: str):
        from xapiand_tpu_torch.utils.rwlock import RWLock

        lk = self._locks.get(index)
        if lk is None:
            with self._locks_guard:
                lk = self._locks.setdefault(index, RWLock())
        return lk

    async def _read_op(self, index: str, fn):
        """Run fn in the worker pool under the index's shared lock."""
        loop = asyncio.get_running_loop()
        lk = self._lock_for(index)

        def work():
            with lk.read():
                return fn()

        return await loop.run_in_executor(self.pool, work)

    async def _write_op(self, index: str, fn):
        """Run fn in the worker pool under the index's exclusive lock."""
        loop = asyncio.get_running_loop()
        lk = self._lock_for(index)

        def work():
            with lk.write():
                return fn()

        return await loop.run_in_executor(self.pool, work)

    def submit_write(self, fn, index=None):
        """Fire-and-forget a write under the index's exclusive lock - the
        autocommit debouncer (timer thread) posts commits through here."""
        if index is None:
            self.pool.submit(fn)
            return

        def work():
            with self._lock_for(index).write():
                fn()

        self.pool.submit(work)

    # -- plumbing --------------------------------------------------------------

    async def handle(self, request: web.Request) -> web.Response:
        t0 = time.time()
        try:
            obj, status = await self._dispatch(request)
        except ApiError as e:
            obj, status = {"#error": {"#message": e.text,
                                      "#code": e.status_code}}, e.status_code
        except VersionConflict as e:
            obj, status = {"#error": {"#message": str(e), "#code": 409}}, 409
        except (QueryDSLError, PatchError, ValueError) as e:
            obj, status = {"#error": {"#message": str(e), "#code": 400}}, 400
        except DocumentNotFound as e:
            obj, status = {"#error": {"#message": f"document not found: {e}",
                                      "#code": 404}}, 404
        took = time.time() - t0
        # per-request response-shaping overrides (http_client.cc:2739-2781:
        # ?pretty ?human ?echo ?comments accept bare or =true/false forms)
        def qflag(name, default):
            if name not in request.query:
                return default
            v = request.query.get(name, "")
            return v.lower() not in ("false", "0", "no")

        opt_echo = qflag("echo", self.opts["echo"])
        opt_human = qflag("human", self.opts["human"])
        opt_comments = qflag("comments", self.opts["comments"])
        if isinstance(obj, dict):
            obj.setdefault("#took", round(took * 1000, 3))
            if opt_echo and status < 300 and "_id" in obj \
                    and request.method in ("PUT", "PATCH", "UPDATE",
                                           "UPSERT"):
                # --echo: document-write responses carry the stored body
                # (≙ opts.h echo; reference echoes the indexed object)
                try:
                    index, _ = parse_path(request.path)
                    index = index.rsplit("/", 1)[0]  # strip the doc id
                    doc = self.man.get(index).get_document(str(obj["_id"]))
                    obj = {**doc, **obj}
                except Exception:
                    pass
            if opt_human and "#took" in obj:
                obj["#took"] = f'{obj["#took"]:.3f}ms'
            if not opt_comments:
                obj = {k: v for k, v in obj.items()
                       if not k.startswith("#") or k == "#error"}
        if isinstance(obj, web.Response):
            return obj
        ct = neg.pick_accept(request.headers.get("Accept"),
                             request.headers.get("Content-Type"))
        pretty = qflag("pretty", self.opts["pretty"]) \
            or "indent" in request.query
        body = neg.encode_body(obj, ct, pretty=pretty)
        return web.Response(body=body, status=status, content_type=ct,
                            headers={"Operation-Time": f"{took:.6f}"})

    def _observe(self, op: str, t0: float):
        if self.registry is not None:
            self.op_count.labels(op).inc()
            self.op_summary.labels(op).observe(time.time() - t0)

    async def _body(self, request):
        raw = await request.read()
        return neg.decode_body(raw, request.headers.get("Content-Type"))

    # -- dispatch (≙ http_client.cc:1034-1219) -----------------------------------

    async def _dispatch(self, request: web.Request):
        t0 = time.time()
        method = request.method.upper()
        override = request.headers.get("X-HTTP-Method-Override") or \
            request.headers.get("HTTP-Method-Override")
        if override:
            # api.md HTTP Method Override: POST only, error otherwise
            if method != "POST":
                raise ApiError(400, "method override requires POST")
            method = override.upper()
        index, cmd = parse_path(request.path)
        # trailing slash = the path names an index, not a document
        # (PathParser-style disambiguation, url_parser.h)
        trailing = request.path != "/" and request.path.endswith("/")
        doc_id = None
        if cmd is None and index and not trailing and method in (
                "PUT", "PATCH", "GET", "HEAD", "DELETE", "UPDATE", "UPSERT",
                "MERGE", "STORE"):
            parts = index.split("/")
            if len(parts) >= 2:
                index, doc_id = "/".join(parts[:-1]), parts[-1]
            elif method in ("PUT", "PATCH", "STORE"):
                raise ApiError(400, "document id required (use /index/id)")

        if method == "OPTIONS":
            # capability discovery (http_client.cc:296 Allow header)
            from aiohttp import web
            return web.Response(status=200, headers={
                "Allow": "GET, POST, PUT, PATCH, UPDATE, UPSERT, STORE, "
                         "DELETE, HEAD, OPTIONS, SEARCH, COUNT, INFO, "
                         "COMMIT, DUMP, RESTORE, CHECK, MERGE, OPEN, "
                         "CLOSE, FLUSH, QUIT"}), None
        if method == "QUIT":
            # admin-gated process shutdown, bare path only
            # (http_client.cc:1192-1203, opts --admin-commands gate)
            if index or cmd is not None:
                raise ApiError(405, "QUIT only applies to /")
            self._require_admin()
            if self.on_quit is not None:
                asyncio.get_running_loop().call_later(0.2, self.on_quit)
            return {"#quit": True}, 200
        if method == "FLUSH":
            # admin-gated: flush databases (commit + close the LRU pool)
            # and/or clients; ?databases / ?clients select one
            # (http_client.cc:1168-1185)
            if index or cmd is not None:
                raise ApiError(405, "FLUSH only applies to /")
            self._require_admin()
            flush_db = "databases" in request.query
            flush_cl = "clients" in request.query
            out = {}
            if flush_db or not flush_cl:
                self.man.flush_autocommit()
                n = 0
                for name in [k for k, d in self.man.indexes.items()
                             if d is not None]:
                    # per-index exclusive lock: never close under a reader
                    if await self._write_op(
                            name, lambda n=name: self.man.flush_one(n)):
                        n += 1
                out["#databases_flushed"] = n
            if flush_cl or not flush_db:
                out["#clients_flushed"] = 0   # asyncio: no pooled clients
            return out, 200

        if not index and cmd is None:
            if method in ("GET", "HEAD"):
                return self._server_info(), 200
            raise ApiError(405, "method not allowed on /")
        if not index and cmd == "metrics":
            return await self._metrics(request)
        if not index and cmd == "nodes":
            if self.cluster is None:
                return {"cluster": False,
                        "nodes": {"localhost": {"state": "alive"}}}, 200
            return self.cluster.cluster_info(), 200

        # command views
        if cmd is not None:
            return await self._command(request, method, index, cmd, t0)

        # method views
        if method in ("SEARCH",):
            return await self._search(request, index, t0)
        if method == "COUNT":
            return await self._count(request, index, t0)
        if method == "INFO":
            return self._info(index), 200
        if method == "COMMIT":
            return await self._write_op(
                index, lambda: self._commit(index)), 200
        if method == "DUMP":
            return await self._dump(request, index)
        if method == "RESTORE":
            return await self._restore(request, index, t0)
        if method == "CHECK":
            return await self._read_op(
                index, lambda: self.man.get(index).check()), 200
        if method == "OPEN":
            # load the index into the pool (reference declares OPEN but
            # 501s it, http_client.cc:1212-1214; here it is real)
            db = await self._read_op(index, lambda: self.man.get(index))
            return {"#open": index, "revision": db.revision}, 200
        if method == "CLOSE":
            # commit + release from the pool; reopens lazily on next use
            closed = await self._write_op(
                index, lambda: self.man.flush_one(index))
            return {"#closed": bool(closed)}, 200
        if method == "POST" and doc_id is None:
            return await self._write_doc(request, index, None, t0)
        if method == "PUT" and doc_id is None:
            # PUT /idx/ (trailing slash) = create/update the INDEX itself,
            # optionally with an explicit or foreign _schema and _settings
            # (create-api.md, explicit-types.md, foreign-schemas.md)
            return await self._create_index(request, index, t0)
        if method == "PUT":
            return await self._write_doc(request, index, doc_id, t0)
        if method == "PATCH":
            return await self._patch_doc(request, index, doc_id, t0)
        if method in ("UPDATE", "MERGE"):
            # UPDATE merges into an EXISTING doc (404 when absent,
            # handler.cc:554-585 update() with create=false)
            return await self._update_doc(request, index, doc_id, t0,
                                          create=False)
        if method == "UPSERT":
            # UPSERT = UPDATE that creates when absent (create=true,
            # http_client.cc:1601-1607)
            return await self._update_doc(request, index, doc_id, t0,
                                          create=True)
        if method == "STORE":
            return await self._store_blob(request, index, doc_id)
        if method in ("GET", "HEAD") and doc_id is not None:
            return self._get_doc(request, index, doc_id, head=method == "HEAD")
        if method in ("GET", "HEAD"):
            return self._info(index), 200
        if method == "DELETE":
            if doc_id is not None:
                return await self._write_op(
                    index,
                    lambda: self._delete_doc(request, index, doc_id, t0))
            self.man.delete(index)
            return {"#deleted": index}, 200
        raise ApiError(405, f"method {method} not supported here")

    async def _command(self, request, method, index, cmd, t0):
        if cmd == "search":
            return await self._search(request, index, t0)
        if cmd == "count":
            return await self._count(request, index, t0)
        if cmd == "info":
            # document info when the path carries an id: /idx/doc/:info
            # (info-api.md: termlist + values + version)
            parts = index.split("/")
            if len(parts) > 1 and self.man.exists("/".join(parts[:-1])):
                return self._doc_info("/".join(parts[:-1]), parts[-1]), 200
            return self._info(index), 200
        if cmd == "schema":
            return self.man.get(index).schema.to_dict(), 200
        if cmd == "settings":
            # per-index IndexSettings (num_shards -> mesh-sharded backend;
            # ≙ index_resolver_lru.h:41-66, persisted like .xapiand/indices)
            if method in ("PUT", "POST", "UPDATE"):
                body = await self._body(request)
                out = self.man.set_settings(index, body)
                if self.cluster is not None:
                    # cluster-wide settings ride the raft log
                    # (≙ RAFT_ADD_COMMAND applying IndexSettings,
                    # discovery.h:65-85)
                    self.cluster.add_command({"type": "index_settings",
                                              "index": index,
                                              "settings": out})
                return out, 200
            return dict(self.man.get_settings(index)), 200
        if cmd == "metadata":
            return await self._metadata(request, method, index)
        if cmd == "commit":
            return await self._write_op(
                index, lambda: self._commit(index)), 200
        if cmd == "dump":
            return await self._dump(request, index)
        if cmd == "restore":
            return await self._restore(request, index, t0)
        if cmd == "check":
            return await self._read_op(
                index, lambda: self.man.get(index).check()), 200
        if cmd == "wal":
            db = self.man.get(index)
            if db.wal is None:
                raise ApiError(400, "index has no WAL (in-memory)")
            frm = int(request.query.get("from", 0))
            return {"wal": db.wal.repr_wal(from_revision=frm)}, 200
        if cmd == "merge":
            n = await self._write_op(
                index, lambda: self.man.get(index).merge_segments())
            return {"#merged": n}, 200
        if cmd == "nearest":
            parts = index.split("/")
            if len(parts) < 2:
                raise ApiError(400, ":nearest needs /index/docid/:nearest")
            idx_name = "/".join(parts[:-1])
            db = self.man.get(idx_name)
            k = int(request.query.get("limit", 10))
            # ?scheme=trad selects TradEWeight feedback (tradeweight.cc;
            # Xapian's default expansion scheme), ?expand_k= its k param
            escheme = request.query.get("scheme", "bo1").lower()
            if escheme not in ("bo1", "trad"):
                raise ApiError(400, f"unknown expansion scheme "
                                    f"{escheme!r} (bo1 or trad)")
            try:
                expand_k = float(request.query.get("expand_k", 1.0))
            except ValueError:
                raise ApiError(400, "expand_k must be a number")
            res = await self._read_op(
                idx_name, lambda: db.find_similar(
                    parts[-1], k=k, scheme=escheme, expand_k=expand_k))
            hits = [{**h.data, "_id": h.id, "_score": h.score}
                    for h in res.hits]
            return {"total": res.total, "hits": hits}, 200
        if cmd == "suggest":
            db = self.man.get(index)
            word = request.query.get("q", "")
            if not word:
                raise ApiError(400, ":suggest needs ?q=word")
            sugg = await self._read_op(
                index, lambda: db.suggest_spelling(
                    word, limit=int(request.query.get("limit", 5))))
            return {"suggestions": sugg}, 200
        if cmd == "spelling":
            # stored spelling table (≙ glass_spelling.cc; WAL ops
            # ADD_SPELLING/REMOVE_SPELLING): GET dumps, POST adds
            # {"word": w[, "freq": n]} or removes with {"remove": true}
            db = self.man.get(index)
            if request.method == "GET":
                return {"spellings": dict(sorted(db._spellings.items()))}, \
                    200
            body = await self._body(request) or {}
            word = body.get("word")
            if not word:
                raise ApiError(400, ":spelling needs {\"word\": ...}")
            freq = int(body.get("freq", 1))
            if body.get("remove"):
                await self._write_op(
                    index, lambda: db.remove_spelling(word, freq))
            else:
                await self._write_op(
                    index, lambda: db.add_spelling(word, freq))
            return {"word": str(word).lower(),
                    "freq": db._spellings.get(str(word).lower(), 0)}, 200
        if cmd == "synonym":
            # stored synonym table (≙ Database::add_synonym /
            # glass_synonym.cc): GET ?term= lists, POST adds
            # {"term": t, "synonym": s} / removes {"remove": s|true}
            db = self.man.get(index)
            if request.method == "GET":
                term = request.query.get("term")
                if term:
                    return {"term": term.lower(),
                            "synonyms": db.synonyms_of(term)}, 200
                return {"synonyms": {k: list(v) for k, v in
                                     sorted(db._synonyms.items())}}, 200
            body = await self._body(request) or {}
            term = body.get("term")
            if not term:
                raise ApiError(400, ":synonym needs {\"term\": ...}")
            rm = body.get("remove")
            if rm is not None:
                await self._write_op(
                    index, lambda: db.remove_synonym(
                        term, None if rm is True else rm))
            else:
                syn = body.get("synonym")
                if not syn:
                    raise ApiError(400,
                                   ":synonym needs {\"synonym\": ...}")
                await self._write_op(
                    index, lambda: db.add_synonym(term, syn))
            return {"term": str(term).lower(),
                    "synonyms": db.synonyms_of(term)}, 200
        if cmd in ("update", "upsert"):
            parts = index.split("/")
            return await self._update_doc(request, "/".join(parts[:-1]),
                                          parts[-1], t0,
                                          create=cmd == "upsert")
        if cmd == "store":
            parts = index.split("/")
            return await self._store_blob(request, "/".join(parts[:-1]),
                                          parts[-1])
        if cmd == "snapshot":
            # GET streams committed segments as LZ4 records (replica
            # full-copy bootstrap, O(bytes) - the REPLY_DB_* file stream,
            # replication_protocol_client.h:68-80); POST checkpoints the
            # snapshot to the data dir and prunes the WAL below it.
            from xapiand_tpu_torch.models.snapshot import snapshot_bytes

            if method in ("POST", "PUT", "COMMIT"):
                path = await self._write_op(
                    index, lambda: self.man.get(index).checkpoint())
                db = self.man.get(index)
                return {"#snapshot": path, "revision": db.revision}, 200
            data = await self._read_op(
                index, lambda: snapshot_bytes(self.man.get(index)))
            return web.Response(
                body=data, content_type="application/octet-stream",
                headers={"X-Snapshot-Revision":
                         str(self.man.get(index).revision)}), 200
        raise ApiError(404, f"unknown command :{cmd}")

    # -- views ---------------------------------------------------------------------

    def _server_info(self):
        import torch

        return {
            "name": "xapiand-tpu",
            "cluster_name": self.opts["cluster_name"],
            "version": __version__,
            "uptime": round(time.time() - self.started, 1),
            "indexes": sorted(self.man.indexes),
            "devices": [torch.cuda.get_device_name(i)
                        for i in range(torch.cuda.device_count())]
            if self.man.device.type == "cuda" else [str(self.man.device)],
        }

    async def _metrics(self, request):
        if self.registry is None:  # pragma: no cover
            raise ApiError(501, "prometheus_client unavailable")
        body = generate_latest(self.registry)
        # subsystem counters (WAL errors, replication, raft) + server
        # gauges: the reference exports these beyond the op summaries
        # (metrics.h:47-105 — xapiand_wal_errors, per-protocol client
        # pool gauges, uptime/running), so a replica falling behind or a
        # corrupt WAL is visible at /:metrics
        from xapiand_tpu_torch.utils import metrics as _metrics

        extra = {
            "xapiand_uptime": round(time.time() - self.started, 1),
            "xapiand_running": 1,
            "xapiand_http_clients_running": self._active_searches,
            "xapiand_http_clients_queue_size":
                self.pool._work_queue.qsize(),
            "xapiand_http_clients_pool_size": self.pool._max_workers,
            "xapiand_http_clients_capacity": max(
                self.pool._max_workers - self._active_searches, 0),
        }
        body += _metrics.exposition(extra).encode()
        return web.Response(body=body,
                            content_type="text/plain"), 200

    def _require_admin(self):
        """FLUSH/QUIT are refused unless --admin-commands was given
        (≙ opts.admin_commands, http_client.cc:1169/1193)."""
        if not self.opts.get("admin_commands"):
            raise ApiError(405, "admin commands are disabled "
                                "(start with --admin-commands)")

    def _check_volatile(self, index, request):
        """``?volatile`` pins a read to the index primary (read-your-writes;
        ≙ query_field.primary, http_client.cc:2921-2933). On a non-primary
        node the request redirects exactly like a write."""
        if "volatile" not in request.query:
            return
        val = request.query.get("volatile", "")
        if val and val.lower() in ("f", "false", "0", "no"):
            return
        self._check_primary(index, request)

    def _check_primary(self, index, request):
        """Writes must land on the index primary; followers redirect with
        the full original path (replica write-forwarding analog of
        shard.cc:272-295 remote open)."""
        if self.cluster is None:
            return
        primary = self.cluster.primary_of(index)
        if primary is None or primary == self.cluster.me.name:
            return
        node = self.cluster.nodes.get(primary)
        if node is None:
            return
        raise web.HTTPTemporaryRedirect(
            location=f"http://{node.host}:{node.http_port}"
                     f"{request.rel_url}")

    @staticmethod
    def _req_version(request, body):
        """?version=N query param or _version in the body (versioning.md)."""
        v = request.query.get("version")
        if v is None and isinstance(body, dict):
            v = body.pop("_version", None)
        return int(v) if v is not None else None

    async def _create_index(self, request, index, t0):
        self._check_primary(index, request)
        raw = await request.read()
        body = neg.decode_body(raw, request.headers.get("Content-Type")) \
            if raw else {}
        if body is None:
            body = {}
        if not isinstance(body, dict):
            raise ApiError(400, "index body must be an object")
        created = not self.man.exists(index)
        if "_settings" in body:
            self.man.set_settings(index, body["_settings"])
        out = {"#index": index}
        if "_schema" in body:
            out["_schema"] = self.man.apply_schema(index, body["_schema"])
        else:
            self.man.get(index, create=True)
        self._observe("index_create", t0)
        return out, 201 if created else 200

    async def _write_doc(self, request, index, doc_id, t0):
        self._check_primary(index, request)
        body = await self._body(request)
        if not isinstance(body, dict):
            raise ApiError(400, "document body must be an object")
        return await self._write_op(
            index, lambda: self._write_doc_sync(request, index, doc_id,
                                                body, t0))

    @staticmethod
    def _inject_data(db, did, data):
        """Inline blob attachment on writes (handler.cc:153 inject_data):
        ``_data``: "raw" (octet-stream) | null (erase) | {_blob,
        _content_type} | [those]. Strings travel as UTF-8 bytes (JSON has
        no binary type; use STORE or MsgPack for raw bytes)."""
        def one(obj):
            if not isinstance(obj, dict):
                raise ApiError(400, "'_data' must be a string, null, an "
                                    "object or an array of objects")
            blob = obj.get("_blob")
            ct = obj.get("_content_type")
            if not isinstance(blob, str):
                raise ApiError(400, "objects in '_data' must contain "
                                    "'_blob' (a string)")
            if not isinstance(ct, str) or "/" not in ct:
                raise ApiError(400, "objects in '_data' must contain a "
                                    "valid '_content_type'")
            db.store_blob(did, ct, blob.encode("utf-8"))

        if isinstance(data, str):
            db.store_blob(did, "application/octet-stream",
                          data.encode("utf-8"))
        elif data is None:
            db.delete_blob(did, "application/octet-stream")
        elif isinstance(data, list):
            for b in data:
                one(b)
        else:
            one(data)

    def _write_doc_sync(self, request, index, doc_id, body, t0):
        db = self.man.get(index, create=True)
        commit = "commit" in request.query
        version = self._req_version(request, body)
        data = body.pop("_data", _MISSING) if isinstance(body, dict) \
            else _MISSING
        did = db.index_document(body, doc_id=doc_id, commit=commit,
                                version=version)
        if data is not _MISSING:
            self._inject_data(db, did, data)
        if not commit:
            self.man.touch(index)
        self._observe("index", t0)
        return {"_id": did, "_version": db.version_of(did),
                "#commit": commit}, 200 if doc_id else 201

    async def _patch_doc(self, request, index, doc_id, t0):
        self._check_primary(index, request)
        patch = await self._body(request)
        return await self._write_op(
            index, lambda: self._patch_doc_sync(request, index, doc_id,
                                                patch, t0))

    def _patch_doc_sync(self, request, index, doc_id, patch, t0):
        db = self.man.get(index)
        version = self._req_version(request, patch if isinstance(patch, dict)
                                    else None)
        doc = db.get_document(doc_id)
        new = apply_patch(doc, patch)
        commit = "commit" in request.query
        db.index_document(new, doc_id=doc_id, commit=commit,
                          version=version)
        if not commit:
            self.man.touch(index)
        self._observe("patch", t0)
        return {"_id": doc_id, "_version": db.version_of(doc_id)}, 200

    async def _update_doc(self, request, index, doc_id, t0, create=True):
        self._check_primary(index, request)
        body = await self._body(request)
        if not isinstance(body, dict):
            raise ApiError(400, "update body must be an object")
        return await self._write_op(
            index, lambda: self._update_doc_sync(request, index, doc_id,
                                                 body, t0, create))

    def _update_doc_sync(self, request, index, doc_id, body, t0,
                         create=True):
        db = self.man.get(index, create=create)
        try:
            doc = db.get_document(doc_id)
        except DocumentNotFound:
            if not create:   # UPDATE is strict; UPSERT creates
                raise
            doc = {}
        version = self._req_version(request, body)
        data = body.pop("_data", _MISSING)
        merged = _deep_merge(doc, body)
        commit = "commit" in request.query
        db.index_document(merged, doc_id=doc_id, commit=commit,
                          version=version)
        if data is not _MISSING:
            self._inject_data(db, doc_id, data)
        if not commit:
            self.man.touch(index)
        self._observe("update", t0)
        return {"_id": doc_id, "_version": db.version_of(doc_id)}, 200

    def _get_doc(self, request, index, doc_id, head=False):
        self._check_volatile(index, request)
        db = self.man.get(index)
        # content-type-addressed blob retrieval: GET with an Accept header
        # matching a STOREd content type streams the blob back
        # (docs/_docs/reference-guide/documents/store-api.md:50,139)
        accept = (request.headers.get("Accept") or "").split(";")[0].strip()
        if accept and "/" in accept and not accept.startswith("*") \
                and accept not in neg.KNOWN_STRUCTURED:
            cts = db.blob_content_types(doc_id)
            if accept in cts:
                raw = db.get_blob(doc_id, accept)
                return web.Response(body=raw, content_type=accept), 200
        doc = dict(db.get_document(doc_id))
        if head:
            return web.Response(status=200), 200
        sel = request.query.get("selector")
        if sel:
            from xapiand_tpu_torch.server.selector import apply_selector
            try:
                picked = apply_selector(doc, sel)
            except KeyError as e:
                raise ApiError(
                    404, f"selector path {sel!r} not in document ({e})")
            if not isinstance(picked, dict):
                picked = {"_selected": picked}
            doc = dict(picked)
        doc["_id"] = doc_id
        doc["_version"] = db.version_of(doc_id)
        return doc, 200

    def _delete_doc(self, request, index, doc_id, t0):
        self._check_primary(index, request)
        db = self.man.get(index)
        version = self._req_version(request, None)
        commit = "commit" in request.query
        db.delete_document(doc_id, commit=commit, version=version)
        if not commit:
            self.man.touch(index)
        self._observe("delete", t0)
        return {"_id": doc_id, "#deleted": True}, 200

    async def _store_blob(self, request, index, doc_id):
        db = self.man.get(index)
        ct = request.headers.get("Content-Type",
                                 "application/octet-stream").split(";")[0]
        raw = await request.read()
        db.store_blob(doc_id, ct, raw)
        return {"_id": doc_id, "#stored": ct, "#size": len(raw)}, 200

    def _info(self, index):
        db = self.man.get(index)
        return db.info()

    def _doc_info(self, index, doc_id):
        """Per-document termlist/values (≙ info_view document info,
        http_client.cc:1791): re-derives the analysis of the stored doc."""
        db = self.man.get(index)
        doc = db.get_document(doc_id)
        idoc = db.schema.index(dict(doc), str(doc_id))
        terms = {}
        for term, entry in sorted(idoc.terms.items()):
            terms[term] = {"_wdf": entry.wdf}
            if entry.positions:
                terms[term]["_positions"] = sorted(entry.positions)
        values = {str(slot): (v[0] if len(v) == 1 else v)
                  for slot, v in sorted(idoc.values.items())}
        return {"_id": doc_id, "_version": db.version_of(doc_id),
                "terms": terms, "values": values}

    def _commit(self, index):
        db = self.man.get(index)
        rev = db.commit()
        return {"#revision": rev}

    async def _dump(self, request, index):
        db = self.man.get(index)
        docs = await self._read_op(index,
                                   lambda: list(db.dump_documents()))
        ct = neg.pick_accept(request.headers.get("Accept"), None)
        if ct == neg.CT_NDJSON:
            return web.Response(body=neg.encode_body(docs, ct),
                                content_type=ct), 200
        return {"#dump": docs}, 200

    async def _restore(self, request, index, t0):
        """Bulk ingest, streaming NDJSON chunk-wise through the parallel
        prepare pipeline (≙ restore_database_view STREAM_NDJSON,
        http_client.cc:2218-2290; counters 2261-2285)."""
        from xapiand_tpu_torch.index.bulk import BulkIndexer

        db = self.man.get(index, create=True)
        ct = request.headers.get("Content-Type", "").split(";")[0].strip()
        indexer = BulkIndexer(db, n_workers=self.man.num_doc_preparers)
        # per-line _op_type (handler.cc:1005-1060): index (default) rides
        # the parallel prepare pipeline; from the first patch/update/merge
        # line on, lines queue as ordered ops applied sequentially after
        # the pipeline flush (stream order preserved, all under the
        # index's write lock in the worker pool)
        seq_ops: list = []

        def handle(doc):
            op = "index"
            if isinstance(doc, dict) and "_op_type" in doc:
                op = str(doc.pop("_op_type"))
            if op not in ("index", "update", "merge", "patch"):
                raise ApiError(400, f"unknown _op_type {op!r}")
            if op == "index" and not seq_ops:
                indexer.prepare(doc)
                return
            seq_ops.append((op, doc))

        def apply_seq(counters):
            for op, doc in seq_ops:
                did = doc.pop("_id", None) if isinstance(doc, dict) \
                    else None
                if op == "index":
                    db.index_document(doc, doc_id=did)
                elif op in ("update", "merge"):
                    if did is None:
                        raise ApiError(400, f"{op} line needs an _id")
                    cur = db.get_document(str(did))
                    db.index_document(_deep_merge(cur, doc),
                                      doc_id=str(did))
                else:   # patch: RFC-6902 ops under "_patch" ([dev]: the
                    # reference feeds the raw line to apply_patch, which
                    # wants an op array)
                    if did is None:
                        raise ApiError(400, "patch line needs an _id")
                    ops = doc.get("_patch")
                    if not isinstance(ops, list):
                        raise ApiError(400,
                                       "patch line needs a '_patch' list")
                    cur = db.get_document(str(did))
                    db.index_document(apply_patch(cur, ops),
                                      doc_id=str(did))
                counters.indexed += 1
                counters.total += 1
            return counters

        if ct in ("application/x-ndjson", "application/ndjson"):
            import json as _json

            async for line in ndjson_lines(request.content.iter_any()):
                handle(_json.loads(line))
        else:
            body = await self._body(request)
            if isinstance(body, dict) and "#dump" in body:
                body = body["#dump"]
            if not isinstance(body, list):
                raise ApiError(400, "restore expects a list of documents")
            for doc in body:
                handle(doc)
        counters = await self._write_op(
            index, lambda: apply_seq(indexer.wait()))
        self._observe("restore", t0)
        out = counters.as_dict()
        out["#restored"] = counters.indexed
        return out, 200

    async def _search(self, request, index, t0):
        self._check_volatile(index, request)
        if "," in index:
            return await self._multi_search(request, index, t0)
        body = await self._body(request) if request.can_read_body else None
        # zero-hop serving path: a plain relevance query on an already-
        # open index whose engine route is the native host scorer runs
        # inline on the event loop - no worker-pool handoff, no batching
        # window. Measured A/B on the chip host (2026-08-19, 50k docs,
        # scripts/concurrent_bench.py): inline 642 qps @1 client (p50
        # 1.48ms) / ~766 @8 (p99 14.4ms) vs pool+SearchBatcher 550 / 749
        # (p99 17.6ms) - inline wins or ties both rows, and a hybrid
        # (inline only when lone) fragmented the batcher and lost @8
        # (650-676). Falls through whenever anything non-plain is
        # requested, the index is cold/lazy, a writer holds (or waits on)
        # the lock, or the engine declines the host route - those take
        # the worker pool, where SearchBatcher still coalesces concurrent
        # device-path queries. XT_INLINE=0 / XT_LONE_BATCH=1 are A/B
        # gates.
        self._active_searches += 1
        try:
            out = self._inline_search(request, index, body, t0)
            if out is not None:
                return out
            return await self._read_op(
                index, lambda: self._search_sync(request, index, body, t0,
                                                 batch=self._active_searches
                                                 > 1 or __import__("os")
                                                 .environ.get("XT_LONE_BATCH")
                                                 == "1"))
        finally:
            self._active_searches -= 1

    _INLINE_BLOCKERS = ("_sort", "_aggs", "_aggregations", "_collapse",
                        "_diversify", "_cluster", "_weight", "_synonyms",
                        "_selector", "_cutoff", "_cutoff_weight",
                        "_check_at_least")

    def _inline_search(self, request, index, body, t0):
        import os
        if os.environ.get("XT_INLINE", "1") == "0":   # serving A/B gate
            return None
        body = body or {}
        if any(body.get(b) for b in self._INLINE_BLOCKERS):
            return None
        if "synonyms" in request.query or "selector" in request.query:
            return None
        db = self.man.indexes.get(index)
        if db is None:        # lazy (unopened) or missing: pool path
            return None
        lk = self._lock_for(index)
        if not lk.try_acquire_read():
            return None
        try:
            ir = self._cached_ir(request, db, index, body)
            k = int(request.query.get("limit", body.get("_limit", 10)))
            offset = int(request.query.get("offset",
                                           body.get("_offset", 0)))
            res = db.try_search_host(ir, k=k, offset=offset)
            if res is None:
                return None
            out = {"total": res.total,
                   "count": len(res.hits),
                   "hits": self._shape_hits(request, db, body, res, None)}
            self._observe("search", t0)
            return out, 200
        except ApiError:
            raise
        except Exception:
            return None       # any surprise: take the full pool path
        finally:
            lk.release_read()

    def _cached_ir(self, request, db, index, body):
        """Parsed-IR cache: hot served queries skip the DSL walk; keyed on
        the literal query plus everything parse depends on (schema object
        + its mutation counter, and the index revision - wildcard/partial
        expansion reads the term dictionary)."""
        q = request.query.get("q")
        qsrc = q if q is not None else \
            body.get("_query", body.get("query", {"_match_all": {}}))
        ckey = (index, repr(qsrc), id(db.schema), db.schema.mutations,
                db.revision)
        ir = self._ir_cache.get(ckey)
        if ir is None:
            dsl = QueryDSL(db.schema, term_expander=db.expand_prefix)
            ir = dsl.parse_string(q) if q is not None else dsl.parse(qsrc)
            if len(self._ir_cache) >= 2048:   # bounded: drop ~oldest half
                for old in list(self._ir_cache)[:1024]:
                    self._ir_cache.pop(old, None)   # racing prunes are ok
            self._ir_cache[ckey] = ir
        return ir

    def _shape_hits(self, request, db, body, res, labels):
        sel = request.query.get("selector", body.get("_selector"))
        hits = []
        for i, h in enumerate(res.hits):
            data = h.data
            if sel:
                from xapiand_tpu_torch.server.selector import apply_selector
                try:
                    data = apply_selector(data, str(sel))
                except KeyError:
                    data = {}
                if not isinstance(data, dict):
                    data = {"_selected": data}
            doc = dict(data)
            doc["_id"] = h.id
            doc["_version"] = db.version_of(h.id)
            doc["_score"] = h.score
            doc["_rank"] = h.rank
            if labels is not None:
                doc["_cluster"] = labels[i]
            hits.append(doc)
        return hits

    def _search_sync(self, request, index, body, t0, batch=True):
        db = self.man.get(index)
        body = body or {}
        # _check_at_least (RESERVED_QUERYDSL_CHECK_AT_LEAST,
        # handler.cc:1113-1120): the reference checks at least this many
        # candidates so matches_estimated is exact up to the threshold.
        # Our counts are ALWAYS exact (a strict superset of any
        # threshold), so the knob is validated like the reference
        # ("must be a unsigned int" → ClientError) and then satisfied by
        # construction. docs/guide/searching.md documents the superset.
        cal = body.pop("_check_at_least", None)
        if cal is not None and (not isinstance(cal, int)
                                or isinstance(cal, bool) or cal < 0):
            raise ApiError(400, "The _check_at_least must be a "
                                "unsigned int")
        ir = self._cached_ir(request, db, index, body)
        # stored-synonym expansion (FLAG_AUTO_SYNONYMS analog): ?synonyms
        # or {"_synonyms": true} expands term leaves from the per-index
        # synonym table into OP_SYNONYM groups (after the IR cache - the
        # transform depends on the mutable synonym table)
        want_syn = body.get("_synonyms")
        if want_syn is None:
            v = request.query.get("synonyms")
            want_syn = v is not None and v.lower() not in ("false", "0",
                                                           "no")
        if want_syn:
            ir = db.expand_stored_synonyms(ir)
        k = int(request.query.get("limit", body.get("_limit", 10)))
        offset = int(request.query.get("offset", body.get("_offset", 0)))
        sort = parse_sort(db.schema, body.get("_sort"))
        aggs = body.get("_aggs") or body.get("_aggregations")
        collapse_slot = None
        collapse_max = 1
        collapse = body.get("_collapse")
        if collapse:
            field = collapse.get("_field") if isinstance(collapse, dict) \
                else collapse
            if isinstance(collapse, dict):
                collapse_max = max(int(collapse.get("_max", 1)), 1)
            spec = db.schema.get_field(str(field))
            if spec.slot is None:
                raise ApiError(400, f"cannot collapse on {field!r}")
            collapse_slot = spec.slot
        # per-query ranking scheme: {"_weight": "pl2"} or
        # {"_weight": {"_scheme": "bm25", "k1": 1.2, "b": 0.75}}
        scheme = None
        wspec = body.get("_weight")
        if wspec is not None:
            from xapiand_tpu_torch.models.weights import get_scheme
            try:
                if isinstance(wspec, dict):
                    params = {k_.lstrip("_"): v for k_, v in wspec.items()
                              if k_ not in ("_scheme", "_name")}
                    scheme = get_scheme(
                        wspec.get("_scheme", wspec.get("_name", "bm25")),
                        **params)
                else:
                    scheme = get_scheme(str(wspec))
            except (ValueError, TypeError) as exc:
                raise ApiError(400, f"bad _weight: {exc}")
        # Enquire::set_cutoff analog (handler.cc:1264): _cutoff is a
        # percent 0-100 of the top attained score, _cutoff_weight an
        # absolute score floor; hits below either are dropped. The
        # reference's own REST plane hard-codes both to 0, so accepting
        # them is a strict superset of its surface.
        try:
            pct_cut = float(body.get("_cutoff", 0) or 0)
            wt_cut = float(body.get("_cutoff_weight", 0) or 0)
        except (TypeError, ValueError):
            raise ApiError(400, "_cutoff/_cutoff_weight must be numbers")
        if not (0 <= pct_cut <= 100):
            raise ApiError(400, "_cutoff must be a percent in [0,100]")
        div = body.get("_diversify")
        clu0 = body.get("_cluster")
        window = float(self.opts.get("search_batch_window") or 0)
        if window > 0 and batch and not sort and not aggs \
                and collapse_slot is None and not div and not clu0 \
                and not pct_cut and not wt_cut:
            # sharded indexes batch too: ShardedDatabase.search_many runs
            # each signature group as one SPMD launch per generation
            # plain relevance top-k: coalesce concurrent requests into one
            # device batch (SearchBatcher -> Database.search_many)
            batcher = self._batchers.get(index)
            if batcher is None:
                with self._locks_guard:
                    batcher = self._batchers.setdefault(
                        index, SearchBatcher(window_s=window))
            res = batcher.run(lambda: self.man.get(index), ir, k, offset,
                              scheme)
        else:
            res = db.search(ir, k=k, offset=offset, sort=sort,
                            collapse_slot=collapse_slot, aggs=aggs,
                            scheme=scheme, collapse_max=collapse_max,
                            percent_cutoff=pct_cut, weight_cutoff=wt_cut)
        if div and res.hits:
            lam = float(div.get("_lambda", 0.5)) if isinstance(div, dict) \
                else 0.5
            res = db.diversify(res, lam=lam)
        labels = None
        clu = body.get("_cluster")
        if clu and res.hits:
            ck = int(clu.get("_k", 3)) if isinstance(clu, dict) else int(clu)
            labels = db.cluster_hits([h.id for h in res.hits], k=ck)
        hits = self._shape_hits(request, db, body, res, labels)
        out = {"total": res.total, "count": len(hits), "hits": hits}
        if res.aggregations is not None:
            out["aggregations"] = res.aggregations
        self._observe("search", t0)
        return out, 200

    async def _multi_search(self, request, index, t0):
        """Comma-separated multi-endpoint search (≙ PathParser
        multi-endpoint paths, url_parser.h:68-102): per-index searches
        merged by score desc (scores are comparable because every index
        uses the two-phase global-stats merge within itself)."""
        body = await self._body(request) if request.can_read_body else None
        body = body or {}
        if body.get("_aggs") or body.get("_aggregations"):
            raise ApiError(400, "aggregations are not supported on "
                                "multi-index searches")
        names = [n for n in index.split(",") if n]
        k = int(request.query.get("limit", body.get("_limit", 10)))
        offset = int(request.query.get("offset", body.get("_offset", 0)))
        q = request.query.get("q")
        loop = asyncio.get_running_loop()

        def work():
            merged = []
            total = 0
            for name in names:
                with self._lock_for(name).read():
                    db = self.man.get(name)
                    dsl = QueryDSL(db.schema,
                                   term_expander=db.expand_prefix)
                    ir = dsl.parse_string(q) if q is not None else \
                        dsl.parse(body.get("_query", {"_match_all": {}}))
                    res = db.search(ir, k=k + offset)
                total += res.total
                for h in res.hits:
                    merged.append((-h.score, name, h))
            return merged, total

        merged, total = await loop.run_in_executor(self.pool, work)
        merged.sort(key=lambda t: (t[0], t[1], t[2].id))
        hits = []
        for rank, (_, name, h) in enumerate(merged[offset:offset + k]):
            doc = dict(h.data)
            doc["_id"] = h.id
            doc["_index"] = name
            doc["_score"] = h.score
            doc["_rank"] = rank
            hits.append(doc)
        self._observe("search", t0)
        return {"total": total, "count": len(hits), "hits": hits}, 200

    async def _count(self, request, index, t0):
        self._check_volatile(index, request)
        body = await self._body(request) if request.can_read_body else None

        def work():
            db = self.man.get(index)
            b = body or {}
            q = request.query.get("q")
            dsl = QueryDSL(db.schema, term_expander=db.expand_prefix)
            ir = dsl.parse_string(q) if q is not None else \
                dsl.parse(b.get("_query", {"_match_all": {}}))
            n = db.count(ir)
            self._observe("count", t0)
            return {"count": n}, 200

        return await self._read_op(index, work)

    async def _metadata(self, request, method, index):
        db = self.man.get(index)
        if method in ("GET", "HEAD"):
            key = request.query.get("key")
            if key:
                val = db.get_metadata(key)
                if val is None:
                    raise ApiError(404, f"metadata {key!r} not found")
                return {key: val}, 200
            return {k: db.get_metadata(k) for k in db.metadata_keys()}, 200
        if method in ("PUT", "POST", "UPDATE"):
            body = await self._body(request)
            if not isinstance(body, dict):
                raise ApiError(400, "metadata body must be an object")
            for k, v in body.items():
                db.set_metadata(k, v)
            return {"#updated": sorted(body)}, 200
        if method == "DELETE":
            # delete_metadata_view (http_client.h:331; empty value =
            # removal, like Xapian set_metadata(""))
            key = request.query.get("key")
            if not key:
                raise ApiError(400, "DELETE :metadata needs ?key=")
            if db.get_metadata(key) is None:
                raise ApiError(404, f"metadata {key!r} not found")
            db.set_metadata(key, None)
            return {"#deleted": key}, 200
        raise ApiError(405, "unsupported metadata method")


async def ndjson_lines(chunks):
    """The non-blank lines of an NDJSON stream of byte chunks, in order.
    Each chunk is split once and its partial last line carried into the
    next (splitting off one line at a time copies the rest of the buffer
    for every line: quadratic in a body that arrives whole)."""
    buf = b""
    async for chunk in chunks:
        *lines, buf = (buf + chunk).split(b"\n")
        for line in lines:
            if line.strip():
                yield line
    if buf.strip():
        yield buf


def _deep_merge(base: dict, update: dict) -> dict:
    out = dict(base)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def create_app(data_dir: Optional[str] = None,
               manager: Optional[IndexManager] = None,
               cluster_config: Optional[dict] = None,
               server_opts: Optional[dict] = None) -> web.Application:
    man = manager or IndexManager(data_dir)
    cluster = None
    replicator = None
    if cluster_config is not None:
        raise NotImplementedError(_MESH_REFUSAL)
    server = RestServer(man, cluster=cluster, replicator=replicator,
                        server_opts=server_opts)
    app = web.Application(client_max_size=256 * 1024 * 1024)
    app["manager"] = man
    app["server"] = server

    async def wire_commit_runner(app):
        man._serving_loop = asyncio.get_running_loop()
        man.commit_runner = server.submit_write

    app.on_startup.append(wire_commit_runner)

    async def shutdown_pool(app):
        server.pool.shutdown(wait=False)

    app.on_cleanup.append(shutdown_pool)
    if cluster is not None:
        async def on_startup(app):
            await cluster.start()
            await replicator.start()

        app.on_startup.append(on_startup)

        async def on_shutdown(app):
            await replicator.stop()
            await cluster.stop()

        app.on_cleanup.append(on_shutdown)
    methods = ["GET", "HEAD", "POST", "PUT", "DELETE", "PATCH",
               "OPTIONS"] + list(CUSTOM_METHODS)
    for m in methods:
        try:
            app.router.add_route(m, "/{tail:.*}", server.handle)
        except (ValueError, RuntimeError):  # pragma: no cover
            pass

    async def on_cleanup(app):
        man.close()

    app.on_cleanup.append(on_cleanup)
    return app
