"""Continuous-batching decode engine on the dense KV cache or on a
block-paged pool (port of ``repro/serve/engine.py``).

A request queue feeds a :class:`SlotScheduler`; every batched
``decode_step`` advances all slots at their own positions (the ``(b,)``
``cache["pos"]`` contract, masked per row down to the flash-decode
kernels); per-slot temperature / eos / max_tokens, completion and
eviction, and tokens/sec + occupancy metrics.

* Dense cache: admission prefills ONE request into a free slot of the
  live cache (resident slots untouched); every leaf is copied, the
  recurrent states of ``ssm`` / ``rec`` layers and the tail's too, and
  an encoder-decoder's cross k / v, projected from the request's
  ``frames`` (a request without frames cross-attends zeros, as in the
  JAX package).
* Paged pool (``page_size``): admission maps pages through
  :class:`~repro_torch.serve.paging.PagedKV` (content-hash prefix
  sharing, copy-on-write of a shared page the slot will write into),
  the prompt lands in ``prefill_chunk``-token chunks interleaved with
  decode bursts, and the slot joins the decode batch (its device
  page-table row leaves the sink) after its last chunk.

Host syncs are amortized: decode runs in bursts of up to
``EOS_CHECK_EVERY`` steps (bounded by the tightest remaining
``max_tokens``), EOS is detected at burst boundaries and tokens sampled
after it are dropped before a result is returned.

On the card the decode step (``decode_step`` + the greedy argmax, the
JAX engine's jitted ``_step`` + ``_argmax``) replays from a CUDA graph
(:mod:`repro_torch.runtime.graphs`): the engine's first burst runs
eagerly (it plans, tunes, builds the kernels), the next one captures
the step over the engine's static buffers -- the token, the cache as
allocated, its ``pos`` and ``page_table`` -- and every later step
replays it.  Everything that writes those buffers between replays
writes in place: admission prefills, chunked prefills, page copies,
the page-table upload, ``pos`` (advanced in place by the step).
Temperature sampling stays outside the graph and reads its static
logits.  Prefill and the page copies stay eager (each prompt length
would be a graph of its own).  A graph serves only the telemetry
recorder it was captured under (or none); another one re-captures.
``graphs=False`` runs every step eagerly; the CPU engine always does.

With :mod:`repro_torch.telemetry` on, the engine emits the reference's
events (``serve.request.queued`` / ``.admitted`` / ``.finished``), spans
(``serve.prefill``, ``serve.prefill_chunk``, ``serve.decode_burst``, each
waiting for its device work, and four per-request lifecycle spans on
their own tracks), counters and gauges (slots active, pages used /
free).  ``generate`` is the lockstep front end, and the engine models
the device-memory bytes a decode step streams
(``modeled_kv_bytes_per_step``, ``modeled_bytes_per_token``; the
``modeled_kv_bytes*`` metrics add them up over a run).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import ops, quant, resolve_device, telemetry
from repro_torch.configs.base import ModelConfig
from repro_torch.core import bandwidth
from repro_torch.models import transformer as T
from repro_torch.runtime import graphs as G
from repro_torch.serve import paging

# EOS completion is checked on the host only every this-many steps; a
# per-token check would force a device->host sync every decode step.
EOS_CHECK_EVERY = 8

#: the ragged acceptance trace — (prompt_len, max_tokens) pairs — whose
#: every request must decode bit-identically to a solo batch-1 greedy run
ACCEPTANCE_TRACE = ((4, 8), (16, 32), (8, 16), (32, 4))


def acceptance_requests(vocab: int, seed: int = 0) -> List["Request"]:
    """The acceptance trace as requests (the same prompts the JAX
    package draws: numpy's generator from ``seed``)."""
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(0, vocab, (p,)).astype(np.int32),
                    max_tokens=mt)
            for p, mt in ACCEPTANCE_TRACE]


@torch.inference_mode()
def solo_greedy(params, cfg: ModelConfig, prompt: np.ndarray,
                max_tokens: int, max_len: int, frames=None) -> np.ndarray:
    """The parity oracle: one request alone at batch 1, greedy — prefill
    (with the request's (F, d) ``frames``, an array or a host tensor,
    for an encoder-decoder) then token-by-token decode, on the
    parameters' device."""
    device = params["embed"].device
    cache = T.init_cache(cfg, 1, max_len, device=device)
    toks = torch.as_tensor(np.asarray(prompt)[None], dtype=torch.int64,
                           device=device)
    if frames is not None:
        frames = torch.as_tensor(frames)[None].to(device)
    logits, cache = T.prefill(params, cfg, toks, cache, frames=frames)
    out = []
    tok = torch.argmax(logits, -1)[:, None]
    for _ in range(max_tokens):
        out.append(tok[0, 0])
        logits, cache = T.decode_step(params, cfg, tok, cache)
        tok = torch.argmax(logits, -1)[:, None]
    return torch.stack(out).cpu().numpy().astype(np.int32)


@dataclasses.dataclass
class Request:
    """One generation request (host-side)."""
    prompt: np.ndarray                   # (s,) int32 prompt token ids
    max_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    arrival: float = 0.0                 # seconds since trace start
    rid: int = -1                        # assigned by submit()
    frames: Optional[np.ndarray] = None  # (F, d) audio stub frames (an
    #                                      array or a host tensor)


@dataclasses.dataclass
class RequestResult:
    rid: int
    prompt_len: int
    tokens: np.ndarray                   # generated ids (EOS-terminated)
    admitted_step: int
    finished_step: int
    arrival: float
    admitted_time: float
    finished_time: float
    queue_wait: float = 0.0              # arrival -> admission seconds
    ttft: float = 0.0                    # arrival -> first sampled token
    prefill_chunks: int = 1              # chunked-prefill admissions > 1

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])


@dataclasses.dataclass
class GenerationResult:
    """What :meth:`DecodeEngine.generate` returns."""
    tokens: np.ndarray                   # (b, steps) generated ids
    steps: int


class SlotScheduler:
    """Pure-host slot allocator: FIFO request queue over ``n_slots``
    cache slots, lowest free slot first."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("a scheduler needs at least one slot")
        self.n_slots = n_slots
        self.queue: Deque[int] = collections.deque()
        self.slot_rid: List[Optional[int]] = [None] * n_slots
        self._free: List[int] = list(range(n_slots))

    @property
    def n_active(self) -> int:
        return self.n_slots - len(self._free)

    @property
    def active_slots(self) -> List[int]:
        return [s for s, r in enumerate(self.slot_rid) if r is not None]

    def has_work(self) -> bool:
        return bool(self.queue) or self.n_active > 0

    def submit(self, rid: int) -> None:
        self.queue.append(rid)

    def admit(self) -> Optional[tuple]:
        """Pop (slot, rid) when a slot is free and a request is queued."""
        if not self.queue or not self._free:
            return None
        slot = min(self._free)
        self._free.remove(slot)
        rid = self.queue.popleft()
        if self.slot_rid[slot] is not None:
            raise RuntimeError("slot double-booked")
        self.slot_rid[slot] = rid
        return slot, rid

    def release(self, slot: int) -> int:
        rid = self.slot_rid[slot]
        if rid is None:
            raise RuntimeError("releasing a free slot")
        self.slot_rid[slot] = None
        self._free.append(slot)
        return rid


@dataclasses.dataclass
class _SlotState:
    """Host-side decode state of one occupied slot."""
    req: Request
    gen: List[int]                       # synced generated token ids
    first: Optional[int]                 # prefill-sampled token
    remaining: int                       # decode steps left
    admitted_step: int
    admitted_time: float
    queue_wait: float = 0.0
    first_token_time: float = 0.0
    admitted_abs: float = 0.0            # perf_counter absolutes for the
    first_abs: float = 0.0               # ... telemetry lifecycle spans
    prefill_chunks: int = 1
    pos: int = 0                         # cache position (KV billing)


@dataclasses.dataclass
class _PrefillState:
    """A paged slot mid-admission: its prompt lands in chunks
    interleaved with decode bursts, and the slot joins the decode batch
    (device page-table row unmasked, first token sampled) after the
    last chunk."""
    req: Request
    row: np.ndarray                      # true (max_pages,) page table
    next_pos: int                        # prompt positions written so far
    chunks: int
    admitted_time: float
    queue_wait: float
    admitted_abs: float = 0.0


class DecodeEngine:
    """Continuous-batching serving engine over ``batch`` cache slots of
    ``max_len`` positions each, on ``device`` (default the CUDA card).
    Temperature and EOS come with each request (``temperature`` /
    ``eos_id`` are the defaults :meth:`generate` gives its requests);
    temperature sampling draws from a ``torch.Generator`` seeded with
    ``seed``.

    ``page_size`` switches the KV cache from dense per-slot rows to a
    block-paged pool (``max_len`` rounds up to a page multiple):
    ``n_pages`` sizes the pool (default: dense-equivalent capacity,
    ``batch * max_len / page_size`` plus the reserved sink page),
    ``prefill_chunk`` splits admissions into chunks of that many prompt
    tokens interleaved with decode bursts, and ``prefix_cache`` turns on
    content-hash prefix sharing (a shared prompt prefix prefills once;
    copy-on-write on the first divergent mid-page write).

    A sliding-window model's dense cache is a ring of ``min(max_len,
    window)`` slots a layer, and the engine still admits requests of up
    to ``max_len`` positions: prefill keeps a longer prompt's
    ring-aligned tail.  A recurrent model (``ssm`` / ``rec`` layers) and
    an encoder-decoder serve on the dense cache only: ``page_size``
    raises for them, as in the JAX package
    (``models.transformer.check_paged``).

    ``graphs`` (default: on the card) replays the decode step from a
    CUDA graph (module docstring); ``graphs=False`` runs it eagerly, and
    on the CPU ``graphs=True`` raises."""

    def __init__(self, params, cfg: ModelConfig, *, batch: int,
                 max_len: int, temperature: float = 0.0,
                 eos_id: Optional[int] = None,
                 page_size: Optional[int] = None,
                 n_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: bool = True, seed: int = 0, device=None,
                 graphs: Optional[bool] = None):
        T.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters are on {params['embed'].device}, "
                             f"the engine runs on {self.device}")
        cuda = self.device.type == "cuda"
        if graphs and not cuda:
            raise ValueError("CUDA graphs need the card; the engine on "
                             f"{self.device} runs its steps eagerly")
        self.graphs = cuda if graphs is None else graphs
        self._graph: Optional[G.Graph] = None
        self._graph_recorder = None     # the telemetry recorder it serves
        self._warm = False              # an eager burst has run
        self.params = params
        self.cfg = cfg
        self.n_slots = self.batch = batch
        self.temperature = temperature
        self.eos_id = eos_id
        self.paged = page_size is not None
        self.page_size = page_size
        self.prefill_chunk = prefill_chunk
        self.kv: Optional[paging.PagedKV] = None
        self._prefilling: Dict[int, _PrefillState] = {}
        if self.paged:
            T.check_paged(cfg, "paged engine")
            if page_size < 1 or (prefill_chunk is not None
                                 and prefill_chunk < 1):
                raise ValueError("page_size and prefill_chunk must be "
                                 "positive")
            # a gathered table as long as a dense cache keeps paged
            # decode bit-identical to dense decode; round up, never down
            max_len = -(-max_len // page_size) * page_size
            max_pages = max_len // page_size
            if n_pages is None:
                n_pages = 1 + self.n_slots * max_pages
            self.kv = paging.PagedKV(self.n_slots, n_pages, page_size,
                                     max_pages, prefix_cache=prefix_cache)
            # the device table is uploaded from this host copy only when
            # a slot is promoted or finishes, never per decode step
            self._table_np = np.full((self.n_slots, max_pages),
                                     paging.SINK_PAGE, np.int32)
        self.max_len = max_len
        self._requests: Dict[int, Request] = {}
        self._sched = SlotScheduler(self.n_slots)
        self._state: Dict[int, _SlotState] = {}
        self._next_rid = 0
        self._cache = None
        self._tok = torch.zeros((self.n_slots, 1), dtype=torch.int64,
                                device=self.device)
        self._burst = torch.zeros((EOS_CHECK_EVERY, self.n_slots),
                                  dtype=torch.int64, device=self.device)
        self._temps = np.zeros((self.n_slots,), np.float32)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.reset_metrics()

    # ------------------------------------------------------------ sampling

    def _sample(self, logits: torch.Tensor, temps: np.ndarray
                ) -> torch.Tensor:
        """logits: (n, V) -> (n,) tokens; greedy rows where temperature
        is 0, categorical at ``logits / temp`` elsewhere."""
        greedy = torch.argmax(logits, dim=-1)
        if not (temps > 0).any():
            return greedy
        t = torch.as_tensor(temps, device=logits.device)
        probs = torch.softmax(logits / t.clamp(min=1e-6)[:, None], dim=-1)
        sampled = torch.multinomial(probs, 1, generator=self._gen)[:, 0]
        return torch.where(t > 0, sampled, greedy)

    # ------------------------------------------------------------- metrics

    def reset_metrics(self) -> None:
        self.metrics = {
            "decode_steps": 0,           # batched decode_step calls
            "useful_slot_steps": 0,      # sum over steps of active slots
            "prefill_tokens": 0,         # exact prompt tokens prefilled
            "generated_tokens": 0,       # tokens in returned results
            "completed": 0,
            "decode_time": 0.0,          # wall seconds inside bursts
            "prefill_time": 0.0,         # wall seconds inside admissions
            "prefill_chunks": 0,         # admission chunks across reqs
            # longest run of prompt tokens prefilled while >= 1
            # decode-ready slot sat waiting — the stall chunking bounds
            "max_prefill_stall_tokens": 0,
            "prefix_hits": 0,
            "prefix_misses": 0,
            "shared_prompt_tokens": 0,   # prompt tokens never prefilled
            "peak_pages_used": 0,        # most pool pages held at once
            # decode KV traffic billed at true per-row positions
            # (page-rounded when paged) vs what dense max_len rows stream
            "modeled_kv_bytes": 0,
            "modeled_kv_bytes_dense_rows": 0,
            "graph_captures": 0,         # decode-step captures
            "graph_replays": 0,          # decode steps replayed
        }
        self._stall_run = 0

    def occupancy(self) -> float:
        """Mean fraction of slots serving a live request per decode step."""
        steps = self.metrics["decode_steps"]
        if steps == 0:
            return 0.0
        return self.metrics["useful_slot_steps"] / (steps * self.n_slots)

    def tokens_per_sec(self) -> float:
        """Decode throughput: generated tokens over wall time spent in
        decode bursts."""
        t = self.metrics["decode_time"]
        return self.metrics["generated_tokens"] / t if t > 0 else 0.0

    # ----------------------------------------------------------- lifecycle

    def submit(self, req: Request) -> int:
        """Queue a request; returns its rid (admission order = FIFO)."""
        # the last generated token is sampled but never written back, so
        # a request occupies cache positions 0..prompt+max_tokens-2
        need = int(req.prompt.shape[0]) + req.max_tokens - 1
        if need > self.max_len:
            raise ValueError(
                f"request needs {need} cache positions (prompt "
                f"{int(req.prompt.shape[0])} + max_tokens {req.max_tokens} "
                f"- 1) but the engine was built with max_len={self.max_len}")
        if req.frames is not None:
            if self.paged:
                # refused here, not at admission inside the serve loop: a
                # bad request must not stop a trace midway
                raise ValueError("paged engine: audio/enc-dec requests "
                                 "unsupported")
            want = (self.cfg.encoder_seq, self.cfg.d_model)
            if not self.cfg.encoder_layers or \
                    tuple(np.shape(req.frames)) != want:
                raise ValueError(f"{self.cfg.name} takes frames of shape "
                                 f"{want if self.cfg.encoder_layers else None}"
                                 f", got {tuple(np.shape(req.frames))}")
        if self.paged:
            total = self.kv.total_pages(need)
            cap = self.kv.pool.n_pages - 1
            if total > cap:
                raise ValueError(
                    f"request needs {total} pages but the pool only has "
                    f"{cap} allocatable pages")
        rid = self._next_rid
        self._next_rid += 1
        req.rid = rid
        self._requests[rid] = req
        self._sched.submit(rid)
        telemetry.event("serve.request.queued", rid=rid,
                        prompt_len=int(req.prompt.shape[0]),
                        max_tokens=req.max_tokens, arrival=req.arrival)
        return rid

    # --------------------------------------------------------- decode step

    def _step(self) -> torch.Tensor:
        """One decode step over the engine's static buffers: ``pos``
        advanced in place, the greedy tokens written into the token
        buffer.  Returns the (slots, V) f32 logits."""
        logits, new = T.decode_step(self.params, self.cfg, self._tok,
                                    self._cache)
        self._cache["pos"].copy_(new["pos"])
        self._tok.copy_(torch.argmax(logits, -1)[:, None])
        return logits

    def _step_graph(self) -> Tuple[Optional[G.Graph], bool]:
        """(the captured step, whether it was captured just now: its
        warm-up ran this burst's first step); (None, False) to run the
        burst eagerly (graphs off, or the engine's first burst)."""
        if not self.graphs or not self._warm:
            return None, False
        rec = telemetry.recorder()
        if self._graph is not None and self._graph_recorder is rec:
            return self._graph, False
        self._graph = None          # frees the old graph's pool first
        self._graph = G.capture(self._step)
        self._graph_recorder = rec
        self.metrics["graph_captures"] += 1
        return self._graph, True

    def _decode_burst(self, k: int) -> np.ndarray:
        """``k`` decode steps; their tokens (k, slots) on the host (the
        burst's one sync)."""
        graph, fresh = self._step_graph()
        for j in range(k):
            if graph is None:
                logits = self._step()
            elif j == 0 and fresh:
                logits = graph.take_first()     # the capture's warm-up
            else:
                logits = graph.replay()
                self.metrics["graph_replays"] += 1
            if (self._temps > 0).any():
                self._tok.copy_(self._sample(logits, self._temps)[:, None])
            self._burst[j].copy_(self._tok[:, 0])
        self._warm = True
        if graph is not None:
            graph.fold()
        return self._burst[:k].cpu().numpy()

    def _ensure_cache(self) -> None:
        if self._cache is None:
            if self.paged:
                self._cache = T.init_paged_cache(
                    self.cfg, self.n_slots, self.kv.pool.n_pages,
                    self.page_size, self.kv.max_pages, device=self.device)
            else:
                self._cache = T.init_cache(self.cfg, self.n_slots,
                                           self.max_len, device=self.device)

    def _note_prefill_stall(self, n_tokens: int) -> None:
        """Account ``n_tokens`` of prefill work done while at least one
        decode-ready slot sat waiting (the stall chunked prefill
        bounds); a decode burst resets the running stall."""
        if self._state:
            self._stall_run += n_tokens
            self.metrics["max_prefill_stall_tokens"] = max(
                self.metrics["max_prefill_stall_tokens"], self._stall_run)

    def _update_page_gauges(self) -> None:
        telemetry.gauge("serve.kv_pages_used").set(self.kv.pool.n_used)
        telemetry.gauge("serve.kv_pages_free").set(self.kv.pool.n_free)

    def _note_pages(self) -> None:
        self.metrics["peak_pages_used"] = max(
            self.metrics["peak_pages_used"], self.kv.pool.n_used)

    def _upload_table(self) -> None:
        """Copy the host page table into the device one, in place."""
        self._cache["page_table"].copy_(torch.from_numpy(self._table_np))

    def _admit(self, slot: int, req: Request,
               clock: Callable[[], float]) -> None:
        """Prefill the request into ``slot`` and sample its first token;
        admission is the time-to-first-token boundary, so the token is
        synced here."""
        plen = int(req.prompt.shape[0])
        adm_time = clock()
        adm_abs = t0 = time.perf_counter()
        queue_wait = max(adm_time - req.arrival, 0.0)
        toks = torch.as_tensor(req.prompt[None, :], dtype=torch.int64,
                               device=self.device)
        frames = req.frames
        if frames is not None:
            if not isinstance(frames, torch.Tensor):
                frames = torch.from_numpy(np.asarray(frames))
            frames = frames[None].to(self.device)
        with telemetry.span("serve.prefill", rid=req.rid, slot=slot,
                            prompt_len=plen) as sp:
            logits, self._cache = T.prefill_into_slot(
                self.params, self.cfg, toks, self._cache, slot,
                max_len=self.max_len, frames=frames)
            temp = np.float32(req.temperature)
            first = self._sample(logits, temp[None])
            sp.sync(first)
        self._tok[slot, 0] = first[0]
        first_tok = int(first[0])                      # host sync
        first_time = clock()
        self.metrics["prefill_time"] += time.perf_counter() - t0
        self._temps[slot] = temp
        self.metrics["prefill_tokens"] += plen
        self.metrics["prefill_chunks"] += 1
        self._note_prefill_stall(plen)
        telemetry.counter("serve.prefill_tokens").add(plen)
        telemetry.event("serve.request.admitted", rid=req.rid, slot=slot,
                        queue_wait=queue_wait,
                        step=self.metrics["decode_steps"])
        self._state[slot] = _SlotState(
            req=req, gen=[], first=first_tok,
            remaining=req.max_tokens - 1,
            admitted_step=self.metrics["decode_steps"],
            admitted_time=adm_time, queue_wait=queue_wait,
            first_token_time=first_time, admitted_abs=adm_abs,
            first_abs=time.perf_counter(), pos=plen)

    def _admit_paged(self, slot: int, req: Request,
                     clock: Callable[[], float]) -> None:
        """Map pages for the request and stage its prompt for chunked
        prefill.  Nothing is computed here beyond a possible
        copy-on-write page copy; the slot joins the decode batch when
        :meth:`_run_prefill_chunk` lands its last chunk."""
        plen = int(req.prompt.shape[0])
        adm_time = clock()
        adm_abs = time.perf_counter()
        queue_wait = max(adm_time - req.arrival, 0.0)
        plan = self.kv.admit(slot, req.prompt, plen + req.max_tokens - 1)
        if plan.cow_src:
            self._cache = T.copy_kv_pages(self._cache, plan.cow_src,
                                          plan.cow_dst)
        if self.kv.prefix is not None:
            if plan.prefix_hit:
                self.metrics["prefix_hits"] += 1
                telemetry.counter("serve.prefix_cache.hits").add(1)
            else:
                self.metrics["prefix_misses"] += 1
                telemetry.counter("serve.prefix_cache.misses").add(1)
            self.metrics["shared_prompt_tokens"] += plan.shared_tokens
        self._note_pages()
        self._update_page_gauges()
        telemetry.event("serve.request.admitted", rid=req.rid, slot=slot,
                        queue_wait=queue_wait,
                        step=self.metrics["decode_steps"],
                        pages=plan.n_pages,
                        shared_tokens=plan.shared_tokens)
        self._prefilling[slot] = _PrefillState(
            req=req, row=self.kv.table_row(slot),
            next_pos=plan.shared_tokens, chunks=0, admitted_time=adm_time,
            queue_wait=queue_wait, admitted_abs=adm_abs)

    def _run_prefill_chunk(self, clock: Callable[[], float]
                           ) -> Optional[RequestResult]:
        """Land ONE prompt chunk for the oldest mid-prefill slot.  On the
        last chunk: sample the first token (the TTFT boundary, synced
        here), unmask the slot's device page-table row, publish its
        prompt pages to the prefix cache and promote it to the decode
        batch.  Returns a result only for max_tokens <= 1 requests,
        which finish at promotion."""
        slot = next(iter(self._prefilling))
        st = self._prefilling[slot]
        req = st.req
        plen = int(req.prompt.shape[0])
        csize = self.prefill_chunk or (plen - st.next_pos)
        chunk = req.prompt[st.next_pos:st.next_pos + csize]
        s = int(chunk.shape[0])
        t0 = time.perf_counter()
        toks = torch.as_tensor(chunk[None, :], dtype=torch.int64,
                               device=self.device)
        with telemetry.span("serve.prefill_chunk", rid=req.rid,
                            slot=slot, start=st.next_pos, tokens=s) as sp:
            logits, self._cache = T.prefill_paged_chunk(
                self.params, self.cfg, toks, self._cache, slot, st.row,
                st.next_pos)
            sp.sync(logits)
        st.next_pos += s
        st.chunks += 1
        self.metrics["prefill_tokens"] += s
        telemetry.counter("serve.prefill_tokens").add(s)
        self._note_prefill_stall(s)
        if st.next_pos < plen:
            self.metrics["prefill_time"] += time.perf_counter() - t0
            return None

        temp = np.float32(req.temperature)
        first = self._sample(logits, temp[None])
        self._tok[slot, 0] = first[0]
        first_tok = int(first[0])                      # host sync
        first_time = clock()
        self.metrics["prefill_time"] += time.perf_counter() - t0
        del self._prefilling[slot]
        self._temps[slot] = temp
        self._table_np[slot] = st.row
        self._upload_table()
        self.kv.register_prefix(slot, req.prompt)
        self.metrics["prefill_chunks"] += st.chunks
        self._note_pages()
        self._update_page_gauges()
        self._state[slot] = _SlotState(
            req=req, gen=[], first=first_tok,
            remaining=req.max_tokens - 1,
            admitted_step=self.metrics["decode_steps"],
            admitted_time=st.admitted_time, queue_wait=st.queue_wait,
            first_token_time=first_time, admitted_abs=st.admitted_abs,
            first_abs=time.perf_counter(), prefill_chunks=st.chunks,
            pos=plen)
        if req.max_tokens <= 1:
            self._sync_slot(slot, None)
            return self._finish(slot, clock())
        return None

    def _finish(self, slot: int, now: float) -> RequestResult:
        """Truncate at EOS / max_tokens, emit the result, free the slot
        (and, paged, its pages and its device table row)."""
        st = self._state.pop(slot)
        req = st.req
        toks = st.gen[:req.max_tokens]
        eos = req.eos_id
        if eos is not None and eos in toks:
            toks = toks[:toks.index(eos) + 1]
        self._temps[slot] = 0.0
        self._sched.release(slot)
        if self.paged:
            self.kv.release(slot)
            self._table_np[slot] = paging.SINK_PAGE
            self._upload_table()
            self._update_page_gauges()
        self._requests.pop(req.rid, None)
        self.metrics["generated_tokens"] += len(toks)
        self.metrics["completed"] += 1
        ttft = max(st.first_token_time - req.arrival, 0.0)
        if telemetry.enabled():
            fin_abs = time.perf_counter()
            arr_abs = st.admitted_abs - st.queue_wait
            common = dict(tid=req.rid, rid=req.rid)
            telemetry.complete_span("serve.request", arr_abs, fin_abs,
                                    prompt_len=int(req.prompt.shape[0]),
                                    n_tokens=len(toks), ttft=ttft,
                                    queue_wait=st.queue_wait, **common)
            telemetry.complete_span("serve.request.queued", arr_abs,
                                    st.admitted_abs, **common)
            telemetry.complete_span("serve.request.prefill",
                                    st.admitted_abs, st.first_abs,
                                    **common)
            telemetry.complete_span("serve.request.decode", st.first_abs,
                                    fin_abs, tokens=len(toks),
                                    attn_plan=self._attn_plan_key(),
                                    **common)
            telemetry.event("serve.request.finished", rid=req.rid,
                            n_tokens=len(toks), ttft=ttft,
                            queue_wait=st.queue_wait,
                            e2e=max(now - req.arrival, 0.0))
            telemetry.counter("serve.generated_tokens").add(len(toks))
            telemetry.counter("serve.completed").add(1)
        return RequestResult(
            rid=req.rid, prompt_len=int(req.prompt.shape[0]),
            tokens=np.asarray(toks, np.int32),
            admitted_step=st.admitted_step,
            finished_step=self.metrics["decode_steps"],
            arrival=req.arrival, admitted_time=st.admitted_time,
            finished_time=now, queue_wait=st.queue_wait, ttft=ttft,
            prefill_chunks=st.prefill_chunks)

    def _sync_slot(self, slot: int, burst_host: Optional[np.ndarray]
                   ) -> None:
        """Pull this burst's tokens for one slot into host state."""
        st = self._state[slot]
        if st.first is not None:
            st.gen.append(st.first)
            st.first = None
        if burst_host is not None:
            st.gen.extend(int(t) for t in burst_host[:, slot])

    def _slot_done(self, slot: int) -> bool:
        st = self._state[slot]
        if len(st.gen) >= st.req.max_tokens:
            return True
        eos = st.req.eos_id
        return eos is not None and eos in st.gen

    @torch.inference_mode()
    def run(self, requests: Optional[List[Request]] = None, *,
            now_fn: Optional[Callable[[], float]] = None,
            poll: float = 0.001) -> List[RequestResult]:
        """Drain the queue (plus ``requests``, submitted first) through
        the slot pool; returns results in completion order.  ``now_fn``
        is the trace clock gating admissions by ``Request.arrival``;
        without it every queued request is admittable at once.

        Paged, one admission is in flight at a time (the next request's
        prefix match must see this prompt's pages, which publish when
        its last chunk lands), and a head-of-line request that does not
        fit waits for pages to free up (after evicting prefix pages no
        slot holds)."""
        for req in requests or ():
            self.submit(req)
        self._ensure_cache()
        now = now_fn or (lambda: float("inf"))
        t_run0 = time.perf_counter()
        clock = now_fn or (lambda: time.perf_counter() - t_run0)
        done: List[RequestResult] = []

        while self._sched.has_work():
            # ---- admissions: fill every free slot with an arrived req
            while self._sched.queue and self._sched._free and \
                    self._requests[self._sched.queue[0]].arrival <= now():
                req = self._requests[self._sched.queue[0]]
                if self.paged:
                    if self._prefilling:
                        break
                    need = int(req.prompt.shape[0]) + req.max_tokens - 1
                    if not self.kv.can_admit(req.prompt, need) and \
                            not self.kv.try_reclaim(req.prompt, need):
                        break   # head-of-line waits for freed pages
                slot, _ = self._sched.admit()
                if self.paged:
                    self._admit_paged(slot, req, clock)
                    continue    # finishes (if ever) at promotion
                self._admit(slot, req, clock)
                if req.max_tokens <= 1:
                    self._sync_slot(slot, None)
                    done.append(self._finish(slot, clock()))

            # ---- chunked prefill: one chunk of the oldest admission,
            #      interleaved with the decode bursts below
            if self._prefilling:
                r = self._run_prefill_chunk(clock)
                if r is not None:
                    done.append(r)

            active = [s for s in self._sched.active_slots
                      if s in self._state]
            telemetry.gauge("serve.slots_active").set(len(active))
            if not active:
                if self._sched.queue and not self._prefilling:
                    time.sleep(poll)       # waiting on the next arrival
                continue

            # ---- decode burst: exact to the tightest max_tokens,
            #      EOS checked at the boundary
            k = min([EOS_CHECK_EVERY]
                    + [self._state[s].remaining for s in active])
            n = max(k, 1)
            with telemetry.span("serve.decode_burst", steps=n,
                                active=len(active),
                                attn_plan=self._attn_plan_key()):
                t_burst0 = time.perf_counter()
                host = self._decode_burst(n)    # (n, slots)
            self.metrics["decode_time"] += time.perf_counter() - t_burst0
            self.metrics["decode_steps"] += n
            self.metrics["useful_slot_steps"] += n * len(active)
            telemetry.counter("serve.decode_steps").add(n)
            self._stall_run = 0            # decode ran; stall over
            for j in range(n):             # KV billed at true positions
                self.metrics["modeled_kv_bytes"] += \
                    self.modeled_kv_bytes_per_step(
                        [self._state[s].pos + j for s in active])
            self.metrics["modeled_kv_bytes_dense_rows"] += \
                n * self._dense_rows_kv_bytes_per_step()
            for s in active:
                self._state[s].remaining -= n
                self._state[s].pos += n

            # ---- sync + completions
            for s in active:
                self._sync_slot(s, host)
                if self._slot_done(s):
                    done.append(self._finish(s, clock()))
            telemetry.gauge("serve.slots_active").set(self._sched.n_active)
        return done

    # ---------------------------------------------------- lockstep front

    def generate(self, prompts, n_steps: int, frames=None, seed: int = 0
                 ) -> GenerationResult:
        """Lockstep front end: prompts (b, s) token ids (a tensor or an
        array), up to ``n_steps`` tokens each, at the engine's
        ``temperature`` / ``eos_id``, returned as a dense (b, steps)
        array; ``frames`` (b, F, d) gives row i the frames ``frames[i]``.
        Rows that finish early (EOS) are padded with ``eos_id`` (0
        without one) — post-EOS samples never leak into the result.
        ``seed`` reseeds the sampling generator.  Each row admits through
        the batch-1 slot prefill; decode runs batched."""
        self._gen.manual_seed(seed)
        if isinstance(prompts, torch.Tensor):
            prompts = prompts.cpu().numpy()
        if isinstance(frames, torch.Tensor):
            frames = frames.cpu()
        prompts_np = np.asarray(prompts).astype(np.int32)
        reqs = [Request(prompt=prompts_np[i], max_tokens=n_steps,
                        temperature=self.temperature, eos_id=self.eos_id,
                        frames=None if frames is None else frames[i])
                for i in range(prompts_np.shape[0])]
        results = {r.rid: r for r in self.run(reqs)}
        ordered = [results[req.rid] for req in reqs]
        steps = max(r.n_tokens for r in ordered)
        fill = self.eos_id if self.eos_id is not None else 0
        out = np.full((len(ordered), steps), fill, np.int32)
        for i, r in enumerate(ordered):
            out[i, :r.n_tokens] = r.tokens
        return GenerationResult(tokens=out, steps=steps)

    # ------------------------------------------------------- cost model

    def _attn_layer_windows(self) -> List[tuple]:
        """(window, layer_count) per attention-family layer kind in the
        stack — the layers that stream KV cache every decode step."""
        cfg = self.cfg
        out = []
        for kind in cfg.layer_pattern:
            if kind in ("attn", "moe"):
                out.append((cfg.window, cfg.repeats))
            elif kind == "local":
                out.append((cfg.local_window, cfg.repeats))
        for kind in cfg.tail_pattern:
            if kind in ("attn", "moe"):
                out.append((cfg.window, 1))
            elif kind == "local":
                out.append((cfg.local_window, 1))
        return out

    def _attn_plan_key(self) -> Optional[str]:
        """The newest decode attention plan (``spec key @ shape ->
        kernel``), attached to the decode-burst and per-request decode
        spans; ``None`` until a decode has planned.  A windowed model's
        dense ring decodes through B4 (``models/transformer.py``
        ``_decode_ring``), so its plan names B4 too."""
        for pl in reversed(ops.attn_plans()):
            if pl.spec.mode in ("decode", "decode_paged"):
                return f"{pl.spec.key}@{pl.shape_key}->{pl.kernel}"
        return None

    def modeled_kv_bytes_per_step(self, positions) -> int:
        """Modeled KV-cache device-memory bytes one batched decode step
        streams, billed at the given true per-row positions
        (window-clamped when dense; whole history pages when paged)."""
        cfg = self.cfg
        total = 0
        for window, count in self._attn_layer_windows():
            total += count * bandwidth.decode_kv_bytes(
                positions, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                dtype=cfg.dtype, window=window, page_size=self.page_size)
        return total

    def _dense_rows_kv_bytes_per_step(self) -> int:
        """What dense per-slot rows stream per step: every slot's full
        ``max_len`` allocation (window-clamped for ring layers),
        regardless of true positions."""
        cfg = self.cfg
        positions = [self.max_len - 1] * self.n_slots
        total = 0
        for window, count in self._attn_layer_windows():
            total += count * bandwidth.decode_kv_bytes(
                positions, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.hd,
                dtype=cfg.dtype, window=window)
        return total

    def modeled_bytes_per_token(self, positions=None) -> int:
        """Modeled device-memory traffic of ONE batched decode step (the
        whole slot pool shares it): the GEMM weight stream (every
        projection leaf read once, at storage width) plus the KV-cache
        stream billed at true per-row positions (live slots by
        default)."""
        total = quant.gemm_weight_bytes(self.params)
        if positions is None:
            positions = [self._state[s].pos for s in sorted(self._state)]
        if positions:
            total += self.modeled_kv_bytes_per_step(positions)
        return total
