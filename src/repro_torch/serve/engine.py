"""Continuous-batching serve engine on a §6-paged KV cache.

The engine couples two layers:

* the virtual-time OCR runtime models the *resources*: request slots are
  a labeled-GUID array (§4 — a creator function makes each slot exactly
  once, so concurrent same-timestamp admissions can never double-create),
  the KV cache is one shared data block whose fixed-size pages are §6
  partitions (disjointness is enforced by ``db_partition``), and session
  eviction rides the runtime's spill machinery — a cold session's pages are
  demoted into an archive block that spills through the IO queue and
  re-materializes on resume via the existing grant-deferral path;
* a pluggable compute backend produces the tokens: ``ModelBackend`` runs
  the real paged torch steps (`repro_torch.serve.steps`),
  ``SyntheticBackend`` is a deterministic token function for open-loop
  benchmark sweeps.

Scheduling is classic continuous batching: an admission queue feeds free
slots, prefill interleaves with the running decode batch, rows join and
leave every step, and page-table indirection keeps the decode tensor at a
fixed (B_cap, max_pages) shape.  Time is virtual
(`StepCost`), which makes the continuous-vs-static comparison and the
p50/p99 numbers deterministic and machine-independent.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import (DbMode, EDT_PROP_MAPPED, NULL_GUID, Runtime, TaskCtx,
                              spawn_main)
from repro_torch.models.layers import _dtype
from repro_torch.serve.steps import (make_paged_decode_step,
                                     make_paged_prefill_step)


# ------------------------------------------------------------------ workload

@dataclasses.dataclass
class Request:
    rid: int
    arrival: float                    # virtual seconds
    prompt: np.ndarray                # (plen,) int32
    gen: int                          # tokens to produce (incl. first)
    out: List[int] = dataclasses.field(default_factory=list)
    t_first: float = -1.0
    t_done: float = -1.0


def poisson_workload(n: int, rate: float, *, prompt_len=(8, 32),
                     gen=(4, 16), vocab: int = 512, seed: int = 0
                     ) -> List[Request]:
    """Open-loop Poisson arrivals: exponential gaps at ``rate`` req/s."""
    rng = np.random.RandomState(seed)
    t, reqs = 0.0, []
    for i in range(n):
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.randint(prompt_len[0], prompt_len[1] + 1))
        g = int(rng.randint(gen[0], gen[1] + 1))
        reqs.append(Request(rid=i, arrival=t,
                            prompt=rng.randint(0, vocab, plen).astype(np.int32),
                            gen=g))
    return reqs


@dataclasses.dataclass
class StepCost:
    """Virtual cost model.  The decode tensor is a fixed (B_cap, ·) shape,
    so a step costs the same whether rows are active or padding — the
    continuous engine wins by keeping more of them useful."""
    prefill_base: float = 2e-3
    prefill_per_tok: float = 1e-4
    decode_base: float = 1e-3
    decode_per_row: float = 1e-4


# ------------------------------------------------------------------ backends

class SyntheticBackend:
    """Deterministic stand-in: the token stream is a pure function of
    (request id, cache length), so eviction timing can never change the
    output — ``restore_row`` verifies the archive bytes round-tripped the
    spill file intact."""

    def __init__(self, page_size: int, *, kv_bytes_per_token: int = 32,
                 vocab: int = 50257):
        self.page = page_size
        self.page_bytes = page_size * kv_bytes_per_token
        self.vocab = vocab
        self._rid = {}

    def _tok(self, rid: int, cur: int) -> int:
        return (rid * 2654435761 + cur * 97) % self.vocab

    def _pattern(self, rid: int, logical_page: int) -> bytes:
        base = (rid * 31 + logical_page * 7) % 256
        return bytes(((base + j) % 256) for j in range(min(self.page_bytes, 64))
                     ) * ((self.page_bytes + 63) // 64)

    def prefill(self, row: int, req: Request, pages: List[int]) -> int:
        self._rid[row] = req.rid
        return self._tok(req.rid, len(req.prompt))

    def decode_step(self, page_table, cur_lens, active, tokens, rids):
        out = np.zeros(len(cur_lens), np.int64)
        for r in np.nonzero(active)[0]:
            out[r] = self._tok(int(rids[r]), int(cur_lens[r]) + 1)
        return out

    def evict_row(self, row: int, pages: List[int]) -> bytes:
        rid = self._rid[row]
        return b"".join(self._pattern(rid, i)[: self.page_bytes]
                        for i in range(len(pages)))

    def restore_row(self, row: int, pages: List[int], raw: bytes,
                    cur_len: int) -> None:
        rid = self._rid[row]
        expect = b"".join(self._pattern(rid, i)[: self.page_bytes]
                          for i in range(len(pages)))
        if raw[: len(expect)] != expect:
            raise RuntimeError(
                f"request {rid}: KV bytes corrupted through the spill "
                f"round-trip")


class ModelBackend:
    """Real paged serving in torch: per-layer page pools on the model's
    device plus the paged prefill / decode steps from
    ``repro_torch.serve.steps``."""

    def __init__(self, model, params, *, pool_pages: int, page_size: int,
                 prompt_pad: int):
        cfg = model.cfg
        if prompt_pad % page_size:
            raise ValueError("prompt_pad must be a multiple of page_size")
        self.model, self.params = model, params
        self.device = model.device
        self.page = page_size
        self.pool_pages = pool_pages
        self.prompt_pad = prompt_pad
        self._dt = _dtype(cfg.dtype)
        shape = (cfg.num_layers, pool_pages, cfg.num_kv_heads, page_size,
                 cfg.head_dim)
        self.k_pools = torch.zeros(shape, dtype=self._dt, device=self.device)
        self.v_pools = torch.zeros(shape, dtype=self._dt, device=self.device)
        itemsize = torch.empty((), dtype=self._dt).element_size()
        self.page_bytes = (2 * cfg.num_layers * cfg.num_kv_heads * page_size
                           * cfg.head_dim * itemsize)
        self._prefill = make_paged_prefill_step(model, page_size)
        self._decode = make_paged_decode_step(model)

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a), device=self.device)

    def prefill(self, row: int, req: Request, pages: List[int]) -> int:
        plen = len(req.prompt)
        if plen > self.prompt_pad:
            raise ValueError(f"prompt {plen} > prompt_pad {self.prompt_pad}")
        tk = np.zeros((1, self.prompt_pad), np.int64)
        tk[0, :plen] = req.prompt
        pg = np.full(self.prompt_pad // self.page, self.pool_pages, np.int64)
        pg[: len(pages)] = pages
        nt, _, self.k_pools, self.v_pools = self._prefill(
            self.params, self.k_pools, self.v_pools, self._tensor(tk), plen,
            self._tensor(pg))
        return int(nt)

    def decode_step(self, page_table, cur_lens, active, tokens, rids):
        nt, _, self.k_pools, self.v_pools, _ = self._decode(
            self.params, self.k_pools, self.v_pools,
            self._tensor(page_table), self._tensor(cur_lens),
            self._tensor(active), self._tensor(tokens.astype(np.int64)))
        return nt.cpu().numpy()

    def evict_row(self, row: int, pages: List[int]) -> bytes:
        # numpy has no bf16: the pages leave the device as raw bytes
        idx = self._tensor(np.asarray(pages, np.int64))
        k = self.k_pools[:, idx].contiguous().view(torch.uint8)
        v = self.v_pools[:, idx].contiguous().view(torch.uint8)
        return k.cpu().numpy().tobytes() + v.cpu().numpy().tobytes()

    def restore_row(self, row: int, pages: List[int], raw: bytes,
                    cur_len: int) -> None:
        idx = self._tensor(np.asarray(pages, np.int64))
        half = len(raw) // 2
        shape = (self.k_pools.shape[0], len(pages), *self.k_pools.shape[2:])
        for pool, chunk in ((self.k_pools, raw[:half]),
                            (self.v_pools, raw[half:])):
            data = torch.frombuffer(bytearray(chunk), dtype=torch.uint8)
            pool[:, idx] = data.view(self._dt).reshape(shape).to(self.device)


# ----------------------------------------------------------- labeled slots

def _slot_creator(ctx, lid, index, paramv, guidv):
    """§4 creator: runs exactly once per slot label, at the owning node,
    no matter how many same-timestamp admissions race on the index."""
    ctx.db_create(paramv[0], props=EDT_PROP_MAPPED)


@dataclasses.dataclass
class _Session:
    req: Request
    slot: int                          # slot index == batch row
    slot_guid: Any = None
    pages: List[int] = dataclasses.field(default_factory=list)
    page_guids: List[Any] = dataclasses.field(default_factory=list)
    cur: int = 0                       # tokens in the KV cache
    produced: int = 0
    last_tok: int = 0
    state: str = "running"             # running | evicted | resuming
    archive: Any = None
    n_pages_archived: int = 0
    just_resumed: bool = False         # decoded 0 tokens since resume


# -------------------------------------------------------------------- engine

class ServeEngine:
    """Continuous-batching loop over a paged KV cache with spill eviction.

    ``b_cap`` slots (= batch rows), ``pool_pages`` pages of
    ``backend.page_bytes`` each inside one shared §6 cache block,
    ``max_pages`` page-table width.  ``resident_budget`` (data blocks per
    node) arms the runtime's spill threshold: session archives past it
    write back to disk through the IO queue and resume via grant deferral.
    """

    def __init__(self, backend, *, b_cap: int, pool_pages: int,
                 max_pages: int, resident_budget: Optional[int] = None,
                 io_latency: float = 2e-3, cost: Optional[StepCost] = None,
                 sanitize: Any = None, monitor: Any = None,
                 admit_max_inflight_io: Optional[int] = None,
                 admit_max_queue_depth: Optional[int] = None,
                 monitor_interval: float = 0.0,
                 on_monitor: Optional[Any] = None):
        self.backend = backend
        self.b_cap = b_cap
        self.pool_pages = pool_pages
        self.max_pages = max_pages
        self.page = backend.page
        self.cost = cost or StepCost()
        self._eps = 1e-9

        # IO backpressure admission gates on live registry values, on top
        # of the free page/slot gates.  Setting either — or asking for
        # interval snapshots — implies monitoring.
        self.admit_max_inflight_io = admit_max_inflight_io
        self.admit_max_queue_depth = admit_max_queue_depth
        self.monitor_interval = float(monitor_interval)
        self.on_monitor = on_monitor
        if monitor is None and (admit_max_inflight_io is not None
                                or admit_max_queue_depth is not None
                                or monitor_interval > 0.0):
            monitor = True

        self.rt = Runtime(spill_threshold=resident_budget,
                          io_latency=io_latency, shard_bits=4,
                          sanitize=sanitize, monitor=monitor)
        self.registry = self.rt.registry
        self.ctx = TaskCtx(self.rt, 0, None)
        self.cache_db, _ = self.ctx.db_create(pool_pages * backend.page_bytes)
        self.slot_map = self.ctx.map_create(b_cap, _slot_creator,
                                            paramv=(64,))
        self.free_pages: List[int] = list(range(pool_pages))
        self.free_slots: deque = deque(range(b_cap))
        self.sessions: Dict[int, _Session] = {}

        self.page_table = np.full((b_cap, max_pages), pool_pages, np.int32)
        self.cur_lens = np.zeros(b_cap, np.int32)
        self.active = np.zeros(b_cap, bool)
        self.tokens = np.zeros(b_cap, np.int32)
        self.rids = np.full(b_cap, -1, np.int64)

        self.t = 0.0
        self.evictions = 0
        self.resumes = 0
        self.peak_spilled = 0
        self._resume_ready: Dict[int, bytes] = {}
        self.deferred_admissions = 0
        self.monitor_snapshots: List[Dict[str, float]] = []
        self._admit_queue: Optional[deque] = None

    # -- time / DES glue ----------------------------------------------------

    def san_report(self):
        """Sanitizer findings for the engine's runtime (needs
        ``sanitize=`` at construction or ``REPRO_SANITIZE`` set)."""
        return self.rt.san_report()

    # -- monitoring ----------------------------------------------------------

    def monitor(self) -> Dict[str, float]:
        """Mid-run snapshot of the whole monitoring registry.

        Callable from inside ``run()`` (via ``monitor_interval`` /
        ``on_monitor``) or between calls: refreshes the live ``io.*``
        gauges to the current virtual instant, stamps the engine's own
        ``serve.*`` gauges, and returns ``Registry.snapshot()`` — no
        virtual time passes, nothing stops.
        """
        reg = self.rt.registry
        if self.rt._mon is not None:
            self.rt._mon.on_io(self.rt.io)
        reg.set("serve.time_s", self.t)
        reg.set("serve.queued",
                0 if self._admit_queue is None else len(self._admit_queue))
        reg.set("serve.sessions", len(self.sessions))
        reg.set("serve.active",
                sum(1 for s in self.sessions.values()
                    if s.state == "running"))
        reg.set("serve.free_pages", len(self.free_pages))
        reg.set("serve.free_slots", len(self.free_slots))
        reg.set("serve.evictions", self.evictions)
        reg.set("serve.resumes", self.resumes)
        reg.set("serve.deferred_admissions", self.deferred_admissions)
        return reg.snapshot()

    def _io_backpressured(self) -> bool:
        """The live-registry admission gate: defer admissions while the
        IO plane is saturated (ops in flight / queued behind the disk
        past the configured bounds), even when pages and a slot are
        free — the page/slot-only gate would admit into the backlog."""
        if (self.admit_max_inflight_io is None
                and self.admit_max_queue_depth is None):
            return False
        if self.rt._mon is not None:
            self.rt._mon.on_io(self.rt.io)
        reg = self.rt.registry
        if (self.admit_max_inflight_io is not None
                and reg.value("io.inflight_ops")
                > self.admit_max_inflight_io):
            return True
        if (self.admit_max_queue_depth is not None
                and reg.value("io.queue_depth")
                > self.admit_max_queue_depth):
            return True
        return False

    def _flush(self) -> None:
        """Drain runtime events up to the engine clock, then pin the DES
        clock to it so newly spawned tasks schedule at engine time."""
        self.rt.run(until=self.t)
        self.rt.clock = max(self.rt.clock, self.t)
        self.peak_spilled = max(self.peak_spilled,
                                self.rt.stats.spilled_objects)

    # -- pages --------------------------------------------------------------

    def _alloc_pages(self, sess: _Session, n: int) -> None:
        """Carve ``n`` fresh pages for ``sess`` out of the shared cache
        block — one ``db_partition`` call, so overlap with any live page
        is a hard runtime error, not a silent corruption."""
        while len(self.free_pages) < n:
            if not self._evict_one(protect=sess):
                raise RuntimeError(
                    f"page pool exhausted: {n} pages needed, "
                    f"{len(self.free_pages)} free, nothing evictable")
        phys = [self.free_pages.pop(0) for _ in range(n)]
        pb = self.backend.page_bytes
        guids = self.ctx.db_partition(
            self.cache_db, [(p * pb, pb) for p in phys])
        row = sess.slot
        for p in phys:
            self.page_table[row, len(sess.pages)] = p
            sess.pages.append(p)
        sess.page_guids.extend(guids)

    def _release_pages(self, sess: _Session) -> None:
        for g in sess.page_guids:
            self.ctx.db_destroy(g)
        self._flush()                     # land the destroys before reuse
        self.free_pages.extend(sess.pages)
        row = sess.slot
        self.page_table[row, :] = self.pool_pages
        sess.pages, sess.page_guids = [], []

    # -- admission ----------------------------------------------------------

    def _admit(self, req: Request) -> _Session:
        slot = self.free_slots.popleft()
        sess = _Session(req=req, slot=slot)
        eng = self

        def _body(paramv, depv, api):
            # §4 slot allocation: the creator makes the slot block exactly
            # once per label; reuse after retirement returns the same GUID
            lid = api.map_get(eng.slot_map, slot)

            def _stamp(pv, dv, a):
                # EW acquire of the slot block: records the request id and
                # touch-stamps the block for the recency spill policy
                dv[0].ptr[:8] = np.frombuffer(
                    np.int64(req.rid).tobytes(), np.uint8)
                return NULL_GUID

            tmpl = api.edt_template_create(_stamp, 0, 1)
            api.edt_create(tmpl, depv=[lid], dep_modes=[DbMode.EW],
                           duration=eng._eps)
            return NULL_GUID

        spawn_main(self.rt, _body, duration=self._eps)
        self._flush()
        m = self.rt.lookup(self.rt.resolve(self.slot_map))
        sess.slot_guid = m.entries[slot]

        plen = len(req.prompt)
        self._alloc_pages(sess, (plen + self.page - 1) // self.page)
        first = self.backend.prefill(slot, req, sess.pages)
        self.t += (self.cost.prefill_base
                   + self.cost.prefill_per_tok * plen)
        self._flush()

        sess.cur = plen
        sess.produced = 1
        sess.last_tok = first
        req.out.append(first)
        req.t_first = self.t
        if self.rt._mon is not None:
            self.rt.registry.histogram("serve.ttft_s").observe(
                self.t - req.arrival)
        self.cur_lens[slot] = plen
        self.tokens[slot] = first
        self.rids[slot] = req.rid
        self.active[slot] = True
        self.sessions[slot] = sess
        if sess.produced >= req.gen:
            self._retire(sess)
        return sess

    def _retire(self, sess: _Session) -> None:
        sess.req.t_done = self.t
        if self.rt._mon is not None:
            self.rt.registry.histogram("serve.latency_s").observe(
                self.t - sess.req.arrival)
        self._release_pages(sess)
        self.active[sess.slot] = False
        self.cur_lens[sess.slot] = 0
        self.rids[sess.slot] = -1
        del self.sessions[sess.slot]
        self.free_slots.append(sess.slot)

    # -- eviction / resume --------------------------------------------------

    def _evict_one(self, protect: Optional[_Session] = None) -> bool:
        cands = [s for s in self.sessions.values()
                 if s.state == "running" and s is not protect and s.pages]
        if not cands:
            return False
        # anti-ping-pong: a freshly resumed session gets to decode at least
        # one token before it can be demoted again, else resume/evict can
        # livelock under sustained page pressure
        fresh = [s for s in cands if not s.just_resumed]
        pool = fresh or cands
        victim = max(pool, key=lambda s: (s.req.gen - s.produced, -s.slot))
        self.evict(victim)
        return True

    def evict(self, sess: _Session) -> None:
        """Demote a session: serialize its pages into an archive block,
        destroy the page partitions, and let the spill policy write the
        cold archive back to disk."""
        raw = self.backend.evict_row(sess.slot, sess.pages)
        g, buf = self.ctx.db_create(max(len(raw), 1))
        if raw:
            buf[: len(raw)] = np.frombuffer(raw, np.uint8)
        sess.archive = g
        sess.n_pages_archived = len(sess.pages)
        self._release_pages(sess)
        self.active[sess.slot] = False
        sess.state = "evicted"
        self.evictions += 1
        self.rt.spill_check(0)           # the archive is new cold memory
        self._flush()

    def _start_resume(self, sess: _Session) -> None:
        """Acquire the (possibly spilled) archive RO from a task: a
        spilled archive defers the grant until the IO-queue read lands —
        the same path §5 unread file chunks take."""
        sess.state = "resuming"
        eng = self

        def _body(paramv, depv, api):
            eng._resume_ready[sess.req.rid] = bytes(depv[0].ptr)
            return NULL_GUID

        def _main(paramv, depv, api):
            tmpl = api.edt_template_create(_body, 0, 1)
            api.edt_create(tmpl, depv=[sess.archive],
                           dep_modes=[DbMode.RO], duration=eng._eps)
            return NULL_GUID

        spawn_main(self.rt, _main, duration=self._eps)
        self._flush()

    def _finish_resume(self, sess: _Session) -> None:
        raw = self._resume_ready.pop(sess.req.rid)
        n = sess.n_pages_archived
        self._alloc_pages(sess, n)
        self.backend.restore_row(sess.slot, sess.pages, raw, sess.cur)
        self.ctx.db_destroy(sess.archive)
        sess.archive = None
        sess.state = "running"
        sess.just_resumed = True
        self.cur_lens[sess.slot] = sess.cur
        self.tokens[sess.slot] = sess.last_tok
        self.active[sess.slot] = True
        self.resumes += 1
        self._flush()

    # -- main loop ----------------------------------------------------------

    def run(self, requests: List[Request]) -> Dict[str, float]:
        pending = deque(sorted(requests, key=lambda r: r.arrival))
        queued: deque = deque()
        self._admit_queue = queued
        next_snap = 0.0
        n_done = 0
        total = len(requests)

        while n_done < total:
            self._flush()
            if self.monitor_interval > 0.0 and self.t >= next_snap:
                snap = self.monitor()
                self.monitor_snapshots.append(snap)
                if self.on_monitor is not None:
                    self.on_monitor(self.t, snap)
                next_snap = self.t + self.monitor_interval
            while pending and pending[0].arrival <= self.t:
                queued.append(pending.popleft())

            # resumed sessions rejoin before new admissions (they arrived
            # first); only land ones whose archive bytes are back
            for sess in list(self.sessions.values()):
                if (sess.state == "resuming"
                        and sess.req.rid in self._resume_ready
                        and len(self.free_pages) > sess.n_pages_archived):
                    self._finish_resume(sess)

            # admissions: prefill interleaves with the running batch
            while queued and self.free_slots:
                if self._io_backpressured():
                    # pages and a slot may be free — the page/slot-only
                    # gate would admit — but the IO plane is saturated:
                    # defer until the backlog drains (its MIoDone events
                    # guarantee forward progress below)
                    self.deferred_admissions += 1
                    break
                req = queued.popleft()
                need = (len(req.prompt) + self.page - 1) // self.page
                if (len(self.free_pages) < need + 1
                        and not any(s.state == "running"
                                    for s in self.sessions.values())):
                    queued.appendleft(req)   # wait for pages, not deadlock
                    break
                before = self._done_count(requests)
                self._admit(req)
                n_done += self._done_count(requests) - before

            # kick resume reads for evicted sessions
            for sess in self.sessions.values():
                if sess.state == "evicted":
                    self._start_resume(sess)

            rows = [s for s in self.sessions.values() if s.state == "running"]
            if not rows:
                nxt = []
                if pending:
                    nxt.append(pending[0].arrival)
                if self.rt._heap:
                    nxt.append(self.rt._heap[0][0])
                if not nxt:
                    if queued:
                        raise RuntimeError("serve engine stalled with "
                                           f"{len(queued)} queued requests")
                    break
                self.t = max(self.t, min(nxt))
                continue

            # grow pages for rows whose next token crosses a boundary;
            # _alloc_pages may evict a session that is still in this
            # snapshot, so re-check state as we go
            for sess in rows:
                if (sess.state == "running"
                        and sess.cur // self.page >= len(sess.pages)):
                    self._alloc_pages(sess, 1)
            rows = [s for s in rows if s.state == "running"]
            if not rows:
                continue

            nt = self.backend.decode_step(self.page_table, self.cur_lens,
                                          self.active, self.tokens,
                                          self.rids)
            self.t += (self.cost.decode_base
                       + self.cost.decode_per_row * self.b_cap)
            for sess in rows:
                row = sess.slot
                sess.just_resumed = False
                sess.cur += 1
                self.cur_lens[row] = sess.cur
                sess.produced += 1
                sess.last_tok = int(nt[row])
                self.tokens[row] = sess.last_tok
                sess.req.out.append(sess.last_tok)
                if sess.produced >= sess.req.gen:
                    self._retire(sess)
                    n_done += 1

        self._flush()
        return self._metrics(requests)

    @staticmethod
    def _done_count(requests) -> int:
        return sum(1 for r in requests if r.t_done >= 0)

    def _metrics(self, requests) -> Dict[str, float]:
        lat = np.array([r.t_done - r.arrival for r in requests])
        tokens = sum(r.gen for r in requests)
        stats = self.rt.stats
        out = {
            "tokens": float(tokens),
            "makespan_s": float(self.t),
            "tok_per_s": tokens / max(self.t, 1e-12),
            "p50_latency_s": float(np.percentile(lat, 50)),
            "p99_latency_s": float(np.percentile(lat, 99)),
            "evictions": float(self.evictions),
            "resumes": float(self.resumes),
            "spilled_objects": float(self.peak_spilled),
            "creator_calls": float(stats.creator_calls),
            "spill_slots_reused": float(stats.spill_slots_reused),
            "deferred_admissions": float(self.deferred_admissions),
        }
        if self.rt._mon is not None:
            # histogram-sourced quantiles: measured distributions over
            # every retirement, not the two-point np.percentile summary
            reg = self.rt.registry
            lat_h = reg.histogram("serve.latency_s")
            ttft_h = reg.histogram("serve.ttft_s")
            out["p50_hist_latency_s"] = lat_h.quantile(0.50)
            out["p99_hist_latency_s"] = lat_h.quantile(0.99)
            out["p99_hist_ttft_s"] = ttft_h.quantile(0.99)
        return out


# ----------------------------------------------------------- static baseline

def run_static(requests: List[Request], b_cap: int,
               cost: Optional[StepCost] = None) -> Dict[str, float]:
    """Static-batch baseline: admit whatever is queued when the engine is
    free (up to ``b_cap``), prefill the batch, decode lockstep until the
    *longest* request finishes, only then admit again.  Same per-step cost
    model as the continuous engine — the drain/fill bubbles are the only
    difference, which is the point of the comparison."""
    cost = cost or StepCost()
    reqs = sorted(requests, key=lambda r: r.arrival)
    t, i, lat, tokens = 0.0, 0, [], 0
    step = cost.decode_base + cost.decode_per_row * b_cap
    while i < len(reqs):
        t = max(t, reqs[i].arrival)
        batch = [reqs[i]]
        i += 1
        while i < len(reqs) and reqs[i].arrival <= t and len(batch) < b_cap:
            batch.append(reqs[i])
            i += 1
        for r in batch:
            t += cost.prefill_base + cost.prefill_per_tok * len(r.prompt)
        # per-request completion credited at its own step (generous to the
        # baseline); the engine still drains to the longest request
        for r in batch:
            lat.append(t + (r.gen - 1) * step - r.arrival)
            tokens += r.gen
        t += (max(r.gen for r in batch) - 1) * step
    lat_a = np.array(lat)
    return {
        "tokens": float(tokens),
        "makespan_s": float(t),
        "tok_per_s": tokens / max(t, 1e-12),
        "p50_latency_s": float(np.percentile(lat_a, 50)),
        "p99_latency_s": float(np.percentile(lat_a, 99)),
    }
