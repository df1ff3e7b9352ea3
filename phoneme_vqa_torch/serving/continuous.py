"""Continuous batching: slot-based decode with step-boundary refill
(counterpart of ``phoneme_vqa_tpu/serving/continuous.py``).

The gathered-batch ``ServingEngine`` runs featurize -> encode -> the whole
decode per batch; a request that arrives mid-decode waits out the decode.
Here:

* **S request slots share one decode state on the device.** Every slot
  advances one token a step at its own position: the step is the model's
  ``decode_step_k`` with K=1 (``models/t5.py: T5Decoder.step_k``, the custom
  and triple decoders' ``step_k``), the per-row step of the pool decode.
* **Prefill is decoupled from decode.** New requests are featurized and
  encoded in fixed chunks of ``prefill_chunk`` rows (the encode launches the
  attention kernels, eagerly), staged, and scattered into free slots by the
  next dispatch; the padding rows of a partial chunk go to one trash slot.
  A request joins the decode at the next dispatch boundary.
* **A dispatch is one CUDA graph replay** on the card: the scatter, then
  ``horizon`` decode steps, captured once at warmup over static buffers (the
  counterpart of the JAX engine's fused decode program). The slot state
  stays on the device; the host reads the horizon's tokens and
  log-probabilities once a dispatch and tracks which slots are live
  itself. On the CPU the same operations run eagerly.

All nine families are served: the engine keys on ``decode_step_k`` and the
answer vocabulary's (bos, eos, pad); the phoneme triple stream argmaxes its
three heads a step and a slot stops at its onset's EOS. Greedy only; f32
answers equal ``executor.infer``'s. In bf16 the one-token window step sums
in another order than the batch decode's step, so a near-tie argmax may
part (PERF.md: the pool decode's 1.29e-2 logit gap).

Over a mesh (as ``serving/engine.py`` describes it): rank 0 plans each
step of the worker loop (a reload at the drain barrier, the chunks to
admit with their slots, the slots to kill, whether to dispatch) and
broadcasts the plan; every rank applies it (:meth:`ContinuousEngine._execute`).
Each data rank owns ``num_slots / data`` slots (``num_slots`` must divide
the axis) and featurizes and prefills the chunks admitted into them; the
model ranks of a data rank hold the same slots at ``H / model`` heads each.
Every rank dispatches together, and the horizon's tokens come back to rank
0 over the link's gloo data group. The other ranks run
:meth:`ContinuousEngine.follow`. Prefills and dispatches run on one thread
a rank (rank 0's worker, a follower's loop) in the plan's order, so every
rank issues the model axis's collectives in one order. The dispatch follows
``serving/engine.py: captured_decode``: each rank captures its own dispatch
graph at warmup over its ``num_slots / data`` slots (at model 1 no
collective is inside; over NCCL at model > 1 the model axis's collectives
are captured inside), and over gloo at model > 1 the dispatch runs
uncaptured.
"""

from __future__ import annotations

import math
import queue
import threading
import time
from concurrent.futures import Future
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import batch_iterator
from ..decode.pool import CACHE_KEYS
from ..decode.speculative import draft_from_pair
from ..models.generate import decode_token_ids
from ..utils.logger import get_logger
from .engine import (
    GROUP_TIMEOUT_S,
    DeviceStream,
    _Request,
    captured_decode,
    coerce_image_id,
    control_link,
    engine_device,
    featurize_requests,
    prometheus_text,
    serving_mesh,
    store_key_type,
    warm_model_group,
)
from .encoding_cache import EncodingCache
from .graphs import capture, check_params_in_place, param_addresses
from .watchdog import StallWatchdog, fail_future

log = get_logger(__name__)

#: (ids key, mask key) pairs the per-slot speculative draft corpus is built
#: from (as models/generate.py's offline SPEC_DECODE)
_SPEC_SOURCES = (
    ("tokenized_ocr", "ocr_attention_mask"),
    ("input_ids", "src_attention_mask"),
)

#: name -> help of the counters ``/metrics`` exports for this engine
CONTINUOUS_COUNTERS = {
    "served": "requests answered",
    "failed": "requests resolved with an error",
    "decode_dispatches": "decode dispatches (horizons) run",
    "cache_hits": "requests answered from the LRU cache",
    "reloads": "hot weight reloads",
    "expired": "requests shed after their deadline passed",
}


class ContinuousEngine:
    """Slot-based continuously batched serving over an executor's model.

    Parameters
    ----------
    executor: constructed executor (weights in place) of ANY of the nine
        families.
    ocr_store / obj_store: preloaded feature stores (as ``ServingEngine``).
    num_slots: concurrent request slots in the decode state. Device cost a
        step scales with S, so size it near the expected concurrency.
    prefill_chunk: rows per prefill; partial chunks pad into a trash slot.
    horizon: decode steps per dispatch (the refill granularity; amortizes
        the per-dispatch host cost).
    max_answer_length: decode length cap (as ``executor.infer``).
    max_queue: -1 auto (4 x num_slots), 0 unbounded, >0 explicit bound on
        queued + drained-but-unslotted requests together.
    warmup: build the slot state (on the card: capture the dispatch graph)
        at construction. On the card the graph is captured at construction
        whatever ``warmup`` says.
    spec_k: >1 turns on per-slot SPECULATIVE decoding: every slot verifies
        a spec_k-token prompt-lookup draft window a step (drafts from the
        request's OCR ++ question ids, ``decode/speculative.py``); answers
        are token for token the plain ones. Stock-T5-decoder families only:
        refused (logged, plain steps) for a custom answer vocabulary.
    stall_timeout_s: a dispatch or prefill blocking longer than this fails
        every in-flight future, marks the engine unhealthy and keeps
        ``stop()`` returning. 0 disables. Deadlines are also enforced
        MID-DECODE: a slotted request whose deadline passes is expired at
        the next dispatch boundary and its slot deactivated.
    group_timeout_s: over a mesh, the control group's timeout (as
        ``ServingEngine``'s).
    """

    def __init__(
        self,
        executor,
        ocr_store: dict,
        obj_store: Optional[dict] = None,
        num_slots: int = 16,
        prefill_chunk: int = 4,
        horizon: int = 8,
        max_answer_length: int = 20,
        max_queue: int = -1,
        warmup: bool = True,
        default_deadline_s: float = 0.0,
        access_log=None,
        confidence: bool = False,
        cache_size: int = 0,
        stall_timeout_s: float = 300.0,
        spec_k: int = 0,
        group_timeout_s: float = GROUP_TIMEOUT_S,
    ):
        model = executor.model
        if not hasattr(type(model), "decode_step_k"):
            raise ValueError(
                f"{type(model).__name__} has no per-row-position decode step (decode_step_k): "
                "continuous batching needs it; serve this model with the gathered-batch engine")
        self.executor = executor
        self.ocr_store = ocr_store
        self.obj_store = obj_store
        self.S = int(num_slots)
        self._mesh = serving_mesh(executor)
        self._link = control_link(group_timeout_s) if self._mesh is not None else None
        self._leader = self._mesh is None or dist.get_rank() == 0
        self._dp = 1 if self._mesh is None else self._mesh.dp
        self._dp_rank = 0 if self._mesh is None else self._mesh.dp_rank
        if self.S % self._dp:
            raise ValueError(f"num_slots {self.S} must divide the mesh's data axis ({self._dp}): "
                             "each data rank owns num_slots / data slots")
        self.S_local = self.S // self._dp  # slots on this rank's device, + a trash slot
        self.C = int(prefill_chunk)
        self.horizon = int(horizon)
        self.max_answer_length = int(max_answer_length)
        self.default_deadline_s = float(default_deadline_s)
        self._access_log = access_log
        self.confidence = bool(confidence)
        self._cache_size = int(cache_size)
        self._cache: dict = {}  # (image_id, question) -> resolved answer
        self._cache_hits = 0
        self._key_type = store_key_type(ocr_store)
        self._known_ids = set(ocr_store)
        if obj_store is not None:
            self._known_ids &= set(obj_store)
        if not self._known_ids:
            raise ValueError("feature store is empty")
        if max_queue < 0:
            max_queue = 4 * self.S
        self.max_queue = max_queue
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=max_queue)
        self._stopped = False
        self._unhealthy: Optional[str] = None
        self._watchdog = StallWatchdog(stall_timeout_s, self._on_stall)
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._reload_lock = threading.Lock()  # serialize /reload + watcher
        self._reload_req = None  # (loadtype, event, err_list) set under _reload_lock
        self._reloads = 0
        self._served = 0
        self._failed = 0
        self._expired = 0
        self._service_ewma = 0.0  # slotted->finished seconds, viability gate
        self._dispatches = 0
        self._dispatch_s = 0.0  # seconds this rank spent in dispatches
        self._prefills = 0  # chunks prefilled
        self._latencies_ms: list = []
        self._slot_steps = 0  # slot-steps decoded (occupancy numerator)
        self._total_steps = 0  # S x steps (occupancy denominator)
        self._spec_tokens = 0  # tokens emitted by speculative acceptance
        self._spec_steps = 0  # device steps a live slot actually consumed

        # components per decode step (1 = token stream, 3 = phoneme triples)
        self._ncomp = int(getattr(type(model), "decode_components", 1))
        self._bos, self._eos, self._pad = decode_token_ids(model)

        self.spec_k = int(spec_k or 0)
        if self.spec_k > 1:
            why = None
            if self._ncomp != 1:
                why = "component-tuple streams decode one triple per step"
            elif not getattr(type(model), "spec_decode_supported", False):
                why = ("drafts are backbone-vocab ids, vocabulary-mismatched with the pluggable "
                       "answer tokenizer")
            elif not any(k in model.BATCH_KEYS for k, _ in _SPEC_SOURCES):
                why = "featurized batch carries no draft source ids"
            if why is not None:
                log.warning(f"(!) continuous spec_k={spec_k} ignored: {why}")
                self.spec_k = 0

        # the ViT encoding table (VIT_CACHE), built before warmup so every
        # prefill takes the vit_encodings input
        self._enc_cache = EncodingCache.maybe_build(executor)
        self._stream = DeviceStream(engine_device(executor))
        self._captures, self.decode_reason = captured_decode(engine_device(executor), self._mesh,
                                                             "each dispatch")
        if self._mesh is not None:
            log.info(f"## continuous serving over a mesh ({self._mesh.describe()}), "
                     f"{self.S_local} of {self.S} slots a data rank; decode {self.decode_reason}")
        self._graph = None
        self._graph_pool = None
        self._state = None  # the slot state and the dispatch's static inputs
        self.capture_s = None  # seconds to capture the dispatch graph
        executor._ensure_params()
        self._param_addresses = param_addresses(model)
        # host mirrors of slot occupancy: request + emitted tokens per slot.
        # A slot is assigned at staging time but only LIVE once its prefilled
        # chunk has been scattered by a dispatch: tokens are read for live
        # slots only.
        self._slot_req: List[Optional[_Request]] = [None] * self.S
        self._slot_toks: List[list] = [[] for _ in range(self.S)]
        self._slot_lps: List[List[float]] = [[] for _ in range(self.S)]
        self._live: List[bool] = [False] * self.S
        self._free = list(range(self.S))
        self._waiting: List[_Request] = []
        # rank 0: the global slots of each chunk staged on each data rank,
        # in its order; every rank: its own staged chunks (cache, enc_mask,
        # src, local slot ids)
        self._staged_slots: List[List[List[int]]] = [[] for _ in range(self._dp)]
        self._staged: List[tuple] = []
        self._stage_errors: dict = {}  # global slot -> why its chunk did not featurize
        self._kill_pending: set = set()  # slot ids expired since the last dispatch
        if self._stream.stream is not None or self._mesh is not None:
            warmup = True  # capture before the worker can touch the stream; in step
        if warmup:
            with self._stream.scope():
                self._warmup()
            self._stream.synchronize()
        if not self._leader:  # a follower: no worker, follow() runs its loop
            return
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="continuous-worker")
        self._worker.start()

    # -- the dispatch ---------------------------------------------------------

    def _dummy_request(self) -> _Request:
        return _Request(next(iter(self._known_ids)), "")

    def _featurize(self, reqs):
        ds = featurize_requests(self.executor, self.ocr_store, self.obj_store, reqs)
        if self._enc_cache is not None:
            self._enc_cache.apply(ds, [r.image_id for r in reqs])
        return ds

    def _chunk_batch(self, reqs) -> dict:
        """Featurize reqs (<= C) into a device batch padded to exactly C rows."""
        ds = self._featurize(reqs)
        if len(ds) != len(reqs):
            raise RuntimeError(f"featurization dropped rows: {len(ds)} != {len(reqs)}")
        batch, _ = next(batch_iterator(ds, self.C, pad_final=True))
        return self.executor._device_batch(batch)

    def _chunk_src(self, mb):
        """(src, valid) draft-corpus arrays (C, Ls) of a chunk's batch."""
        parts = [(mb[k], mb.get(m)) for k, m in _SPEC_SOURCES if k in mb]
        src = torch.cat([p.long() for p, _ in parts], dim=1)
        valid = torch.cat([torch.ones_like(p, dtype=torch.bool) if m is None else m.bool()
                           for p, m in parts], dim=1)
        return src, valid

    @torch.inference_mode()
    def _prefill(self, mb):
        """Encode a chunk's batch (the attention kernels launch here); (the
        chunk's cache, full bias, encoder mask, draft corpus or None)."""
        cache, full_bias, enc_mask = self.executor.model.encode_for_generate(
            mb, self.max_answer_length)
        src = self._chunk_src(mb) if self.spec_k > 1 else None
        return cache, full_bias, enc_mask, src

    @torch.inference_mode()
    def _warmup(self):
        """Allocate the slot state and the dispatch's static inputs from one
        prefilled dummy chunk, run the dispatch once and, on the card,
        capture it."""
        t0 = time.perf_counter()
        self.executor.model.eval()
        cache, full_bias, enc_mask, src = self._prefill(
            self._chunk_batch([self._dummy_request()]))
        s1, dev = self.S_local + 1, enc_mask.device

        def slots_of(x, axis):  # chunk rows -> S + 1 slot rows
            shape = list(x.shape)
            shape[axis] = s1
            return torch.zeros(shape, dtype=x.dtype, device=x.device)

        st = {n: slots_of(cache[n], 1) for n in CACHE_KEYS}
        st["enc_mask"] = slots_of(enc_mask, 0)
        st["pos"] = torch.zeros(s1, dtype=torch.long, device=dev)
        cur_shape = (s1,) if self._ncomp == 1 else (s1, self._ncomp)
        st["cur"] = torch.full(cur_shape, self._bos, dtype=torch.long, device=dev)
        st["active"] = torch.zeros(s1, dtype=torch.bool, device=dev)
        # the dispatch's static inputs: the staged chunk, its slots, the
        # kill mask; and its outputs
        st["chunk_ck"] = torch.empty_like(cache["ck"])
        st["chunk_cv"] = torch.empty_like(cache["cv"])
        st["chunk_mask"] = torch.empty_like(enc_mask)
        st["slot_ids"] = torch.full((self.C,), self.S_local, dtype=torch.long, device=dev)
        st["kill"] = torch.zeros(s1, dtype=torch.bool, device=dev)
        st["full_bias"] = None if full_bias is None else full_bias.clone()
        k = max(self.spec_k, 1)
        tok_shape = (self.horizon, s1) + ((self._ncomp,) if self._ncomp > 1 else ())
        if self.spec_k > 1:
            st["src"] = slots_of(src[0], 0)
            st["valid"] = slots_of(src[1], 0)
            st["prev"] = torch.full((s1,), self._bos, dtype=torch.long, device=dev)
            st["chunk_src"] = torch.empty_like(src[0])
            st["chunk_valid"] = torch.empty_like(src[1])
            tok_shape = (self.horizon, s1, k)
            st["n_eff"] = torch.zeros((self.horizon, s1), dtype=torch.long, device=dev)
        st["toks"] = torch.zeros(tok_shape, dtype=torch.long, device=dev)
        st["lps"] = torch.zeros((self.horizon, s1) + ((k,) if self.spec_k > 1 else ()),
                                dtype=torch.float32, device=dev)
        self._state = st
        self._load_chunk(cache, enc_mask, src, [], [])
        self._dummy = (cache, enc_mask, src)
        if self._captures:
            warm_model_group(self._mesh)
            self._graph_pool = torch.cuda.graph_pool_handle()
            self._graph = capture(self._advance, self._graph_pool)
        else:
            self._advance()
        self.capture_s = time.perf_counter() - t0

    def _load_chunk(self, cache, enc_mask, src, slots: List[int], kills: List[int]) -> None:
        """A prefilled chunk and its (local) slots into the dispatch's static
        inputs (pad rows -> the trash slot), and the slots to kill."""
        st = self._state
        st["chunk_ck"].copy_(cache["ck"])
        st["chunk_cv"].copy_(cache["cv"])
        st["chunk_mask"].copy_(enc_mask)
        if src is not None:
            st["chunk_src"].copy_(src[0])
            st["chunk_valid"].copy_(src[1])
        ids = np.full((self.C,), self.S_local, np.int64)
        ids[: len(slots)] = slots
        st["slot_ids"].copy_(torch.from_numpy(ids))
        kill = np.zeros((self.S_local + 1,), bool)
        kill[list(kills)] = True
        st["kill"].copy_(torch.from_numpy(kill))

    def _advance(self) -> None:
        """One dispatch, in place on the slot state: deactivate the killed
        slots, scatter the staged chunk into its slots, then ``horizon``
        decode steps. What a CUDA graph captures."""
        st = self._state
        slots = st["slot_ids"]
        # deadline-expired slots deactivate BEFORE the insert, so a slot
        # expired and re-admitted in the same dispatch comes back live
        st["active"] &= ~st["kill"]
        for n in ("k", "v"):
            st[n].index_fill_(1, slots, 0)
        st["ck"].index_copy_(1, slots, st["chunk_ck"])
        st["cv"].index_copy_(1, slots, st["chunk_cv"])
        st["enc_mask"].index_copy_(0, slots, st["chunk_mask"])
        st["pos"].index_fill_(0, slots, 0)
        st["cur"].index_fill_(0, slots, self._bos)
        if self.spec_k > 1:
            st["src"].index_copy_(0, slots, st["chunk_src"])
            st["valid"].index_copy_(0, slots, st["chunk_valid"])
            st["prev"].index_fill_(0, slots, self._bos)
        st["active"].index_fill_(0, slots, True)
        st["active"][self.S_local:].fill_(False)  # the trash slot never decodes (a kernel, no copy)
        step = self._spec_step if self.spec_k > 1 else self._step
        for h in range(self.horizon):
            step(h)

    def _step_k(self, window):
        st = self._state
        cache = {n: st[n] for n in CACHE_KEYS}
        logits, _ = self.executor.model.decode_step_k(window, cache, st["pos"], st["full_bias"],
                                                      st["enc_mask"])
        return logits

    def _step(self, h: int) -> None:
        """One token a slot (``decode/pool.py``'s step): greedy token, its
        f32 log-probability (summed over a triple's heads), positions and
        active flags advanced."""
        st = self._state
        active = st["active"]
        if self._ncomp == 1:
            logits = self._step_k(st["cur"][:, None])
            tok = logits[:, 0].argmax(dim=-1)
            tok_lp = torch.log_softmax(logits[:, 0].float(), dim=-1).gather(
                1, tok[:, None])[:, 0]
            tok = torch.where(active, tok, self._pad)
            stop_tok, keep = tok, active
        else:
            logits = self._step_k(st["cur"][:, None, :])
            tok = torch.stack([l[:, 0].argmax(dim=-1) for l in logits], dim=-1)
            tok_lp = sum(torch.log_softmax(l[:, 0].float(), dim=-1).gather(
                1, tok[:, c][:, None])[:, 0] for c, l in enumerate(logits))
            tok = torch.where(active[:, None], tok, self._pad)
            stop_tok, keep = tok[:, 0], active[:, None]  # the onset's EOS ends the row
        new_pos = st["pos"] + active.long()
        st["cur"].copy_(torch.where(keep, tok, st["cur"]))
        st["active"].copy_(active & (stop_tok != self._eos)
                           & (new_pos < self.max_answer_length - 1))
        st["pos"].copy_(new_pos)
        st["toks"][h] = tok
        st["lps"][h] = tok_lp

    def _spec_step(self, h: int) -> None:
        """Per-slot speculative step (``decode/speculative.py`` at per-slot
        state): draft K-1 continuations from the slot's source ids, verify
        the window in one ``decode_step_k``, accept the longest matching
        prefix: 1..K tokens a step."""
        st, k, maxl, pad, eos = self._state, self.spec_k, self.max_answer_length, self._pad, \
            self._eos
        active, pos, cur = st["active"], st["pos"], st["cur"]
        drafts = draft_from_pair(st["src"], st["valid"], cur, st["prev"], pos > 0, k - 1, pad)
        window = torch.cat([cur[:, None], drafts], dim=1)  # (S+1, K)
        logits = self._step_k(window)
        greedy = logits.argmax(dim=-1)
        match = (window[:, 1:] == greedy[:, :-1]).long()
        n_acc = 1 + torch.cumprod(match, dim=1).sum(dim=1)
        n_acc = torch.minimum(n_acc, (maxl - 1) - pos)
        jj = torch.arange(k, device=pos.device)[None, :]
        toks = torch.where(jj < n_acc[:, None], greedy, pad)
        is_eos = (toks == eos).long()
        eos_before = torch.cumsum(is_eos, dim=1) - is_eos
        keep = (jj < n_acc[:, None]) & (eos_before == 0) & active[:, None]
        toks = torch.where(keep, toks, pad)
        n_eff = keep.long().sum(dim=1)
        tok_lp = torch.log_softmax(logits.float(), dim=-1).gather(2, greedy[..., None])[..., 0]
        tok_lp = torch.where(keep, tok_lp, 0.0)
        new_pos = pos + n_eff
        # slide (prev, cur) to the last two tokens at the new position
        last = greedy.gather(1, (n_eff - 1).clamp(min=0)[:, None])[:, 0]
        before = greedy.gather(1, (n_eff - 2).clamp(min=0)[:, None])[:, 0]
        st["prev"].copy_(torch.where(n_eff >= 2, before,
                                     torch.where(n_eff == 1, cur, st["prev"])))
        st["cur"].copy_(torch.where(n_eff > 0, last, cur))
        st["active"].copy_(active & ~(keep & (toks == eos)).any(dim=1) & (new_pos < maxl - 1))
        st["pos"].copy_(new_pos)
        st["toks"][h] = toks
        st["lps"][h] = tok_lp
        st["n_eff"][h] = n_eff

    @torch.inference_mode()
    def _dispatch(self, staged, kills=()):
        """Load the staged chunk (or the dummy one, into the trash slot) and
        the (local) slots to kill, and run one dispatch; the horizon's
        (tokens, log-probs, accepted counts or None) of this rank's slots on
        the host."""
        if staged is None:
            cache, enc_mask, src = self._dummy
            self._load_chunk(cache, enc_mask, src, [], kills)
        else:
            cache, enc_mask, src, slots = staged
            self._load_chunk(cache, enc_mask, src, slots, kills)
        if self._graph is not None:
            self._graph.replay()
        elif self._captures:
            raise RuntimeError("the dispatch graph was dropped: the engine stopped")
        else:
            self._advance()
        st, n = self._state, self.S_local
        neff = st["n_eff"][:, :n].cpu().numpy() if self.spec_k > 1 else None
        return st["toks"][:, :n].cpu().numpy(), st["lps"][:, :n].cpu().numpy(), neff

    # -- client surface ---------------------------------------------------------

    def submit(self, image_id, question: str, deadline_s: float = None,
               adapter: str = None) -> Future:
        # signature-compatible with ServingEngine.submit so the serve.py
        # front-ends drive either engine
        if adapter is not None:
            raise KeyError(f"unknown adapter {adapter!r} (continuous engine serves base only)")
        with self._lock:
            if self._unhealthy is not None:
                raise RuntimeError(f"engine unhealthy: {self._unhealthy}")
            if self._stopped:
                raise RuntimeError("engine stopped")
        image_id = coerce_image_id(image_id, self._key_type)
        if image_id not in self._known_ids:
            raise KeyError(f"unknown image_id {image_id!r}")
        if self._cache_size:
            key = (image_id, question)
            hit = object()  # sentinel: None is not a valid cached answer
            answer = hit
            with self._stats_lock:
                if key in self._cache:
                    answer = self._cache.pop(key)
                    self._cache[key] = answer  # move-to-end: LRU
                    self._cache_hits += 1
            if answer is not hit:
                self._record(_Request(image_id, question), "cached")
                fut: Future = Future()
                fut.set_result(answer)
                return fut
        if deadline_s is None and self.default_deadline_s > 0:
            deadline_s = self.default_deadline_s
        deadline = time.monotonic() + deadline_s if deadline_s else None
        req = _Request(image_id, question, deadline)
        with self._lock:
            if self._unhealthy is not None:
                raise RuntimeError(f"engine unhealthy: {self._unhealthy}")
            if self._stopped:
                raise RuntimeError("engine stopped")
            # the worker drains the queue into self._waiting between
            # dispatches, so qsize() alone is ~0 under load: bound queued +
            # drained-but-unslotted together
            if self.max_queue and (self._queue.qsize() + len(self._waiting) >= self.max_queue):
                raise RuntimeError(f"serving queue full ({self.max_queue} pending)")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                raise RuntimeError(f"serving queue full ({self._queue.maxsize} pending)") from None
        return req.future

    def answer(self, image_id, question: str, timeout=None, deadline_s=None):
        return self.submit(image_id, question, deadline_s).result(timeout=timeout)

    def stats(self) -> dict:
        with self._stats_lock:
            lats = sorted(self._latencies_ms)
            pct = (lambda p: lats[min(len(lats) - 1, int(p * len(lats)))]  # noqa: E731
                   if lats else None)
            occ = self._slot_steps / self._total_steps if self._total_steps else 0.0
            return {
                "served": self._served,
                "failed": self._failed,
                "expired": self._expired,
                "unhealthy": self._unhealthy,
                "decode": self.decode_reason.split(":")[0],
                "decode_reason": self.decode_reason,
                **({"mesh": self._mesh.describe()} if self._mesh is not None else {}),
                "decode_dispatches": self._dispatches,
                "dispatch_s": self._dispatch_s,
                "prefill_chunks": self._prefills,
                "reloads": self._reloads,
                "cache_hits": self._cache_hits,
                "slot_occupancy": round(occ, 3),
                "service_ewma_s": round(self._service_ewma, 3),
                **({
                    "spec_k": self.spec_k,
                    # mean accepted tokens per device step a live slot
                    # consumed (1.0 = no draft ever accepted; up to spec_k)
                    "spec_tokens_per_step": round(self._spec_tokens / self._spec_steps, 3)
                    if self._spec_steps else None,
                } if self.spec_k > 1 else {}),
                "queue_depth": self._queue.qsize(),
                "p50_ms": pct(0.50),
                "p95_ms": pct(0.95),
                **({"vit_cache": self._enc_cache.stats()} if self._enc_cache is not None else {}),
            }

    def prometheus_metrics(self) -> str:
        return prometheus_text(self.stats(), CONTINUOUS_COUNTERS)

    def reload(self, loadtype: str = "best") -> dict:
        """Swap the serving weights with ANSWER-ATOMIC semantics: a drain
        barrier on the worker pauses admission, lets the live slots finish
        (at most max_answer_length steps), then copies the checkpoint into
        the parameters' own storage (the captured graph reads it there) and
        recomputes the relative bias. A slot's prefill and decode always use
        one set of weights. Requests arriving during the barrier queue up
        and decode under the new weights."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine stopped")
        t0 = time.monotonic()
        with self._reload_lock:
            ev = threading.Event()
            err: list = []
            self._reload_req = (loadtype, ev, err)
            while not ev.wait(timeout=0.5):
                if self._unhealthy is not None or not self._worker.is_alive():
                    self._reload_req = None
                    raise RuntimeError(f"engine unhealthy: {self._unhealthy}")
        if err:
            raise err[0]
        with self._stats_lock:
            self._cache.clear()  # entries are stale under the new weights
            self._reloads += 1
        ms = (time.monotonic() - t0) * 1e3
        log.info(f"## hot-reloaded {loadtype}_ckp in {ms:.0f} ms (continuous)")
        return {"reloaded": loadtype, "ms": round(ms, 1)}

    def _reload_weights(self, loadtype: str) -> Optional[Exception]:
        """Every rank, at the drain barrier (no live slots, no staged
        chunks): load the weights in place, then the relative bias and the
        dummy chunk they determine (whose prefill every rank runs, a failed
        load or not). Returns the load's error, or None."""
        err = None
        try:
            self.executor._load_trained_checkpoint(loadtype)
            self._stream.synchronize()
            check_params_in_place(self.executor.model, self._param_addresses)
        except Exception as e:  # surfaced to the caller
            err = e
        if self._enc_cache is not None:
            self._enc_cache.flush()  # stale under the new ViT weights
        cache, full_bias, enc_mask, src = self._prefill(
            self._chunk_batch([self._dummy_request()]))
        if full_bias is not None:
            with torch.inference_mode():  # the state's tensors are inference tensors
                self._state["full_bias"].copy_(full_bias)
        self._dummy = (cache, enc_mask, src)
        return err

    @property
    def unhealthy_reason(self) -> Optional[str]:
        """Non-None once the stall watchdog (or a raising dispatch) declared
        the engine dead: ``/healthz`` turns 503."""
        return self._unhealthy

    def stop(self):
        """Drain and stop. ALWAYS returns: a worker stuck on a dead device
        cannot be joined; once the watchdog declares the stall (or it already
        has), the stuck daemon thread is abandoned."""
        with self._lock:
            already = self._stopped
            self._stopped = True
        if not self._leader:  # a follower stops at rank 0's stop message
            return
        if already and not self._worker.is_alive():
            return
        while self._worker.is_alive():
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass  # the worker drains it (or is stuck: the watchdog decides)
            self._worker.join(timeout=0.5)
            if self._unhealthy:
                self._worker.join(timeout=1.0)
                if self._worker.is_alive():
                    log.warning("(!) stop(): abandoning worker stuck on a dead device "
                                "(daemon thread)")
                break
        if not self._worker.is_alive():
            self._close_graph()
        self._watchdog.close()

    def _close_graph(self) -> None:
        """Drop the dispatch graph once no thread dispatches; a later
        dispatch raises (``GraphDecoder.close`` says why: over NCCL, before
        the process group goes)."""
        self._stream.synchronize()
        self._graph = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- failure handling -----------------------------------------------------

    def _on_stall(self, label: str, waited: float) -> None:
        self._fail_inflight(RuntimeError(
            f"device stall: {label} blocked {waited:.0f}s (lost or hung card?)"))

    def _fail_inflight(self, exc: Exception) -> None:
        """Mark unhealthy and resolve every in-flight and queued future with
        ``exc``. Idempotent; from the watchdog's monitor thread (worker
        stuck) or the worker thread (a dispatch raised)."""
        with self._lock:
            if self._unhealthy is not None:
                return
            self._unhealthy = str(exc)
            self._stopped = True
        n = 0
        for s in range(self.S):
            req = self._slot_req[s]
            if req is not None:
                n += fail_future(req.future, exc)
        for req in self._waiting:
            n += fail_future(req.future, exc)
        while True:  # queued but not yet drained by the worker
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                n += fail_future(item.future, exc)
        rl = self._reload_req
        if rl is not None:  # a reload caller is blocked on the barrier
            _, ev, err = rl
            err.append(RuntimeError(f"engine unhealthy: {exc}"))
            ev.set()
        with self._stats_lock:
            self._failed += n
        log.error(f"(!!) engine unhealthy ({exc}): failed {n} in-flight request(s); "
                  "submits now reject")

    # -- worker -------------------------------------------------------------------

    def _record(self, req, status, **extra):
        if self._access_log is None:
            return
        image_id = req.image_id
        rec = {
            "ts": round(time.time(), 3),
            "image_id": image_id.item() if hasattr(image_id, "item") else image_id,
            "question_chars": len(req.question),
            "status": status,
            "latency_ms": round((time.monotonic() - req.t_submit) * 1e3, 3),
            **extra,
        }
        try:
            self._access_log(rec)
        except Exception as e:
            log.warning(f"(!) access-log sink raised {e!r}: disabled")
            self._access_log = None

    def _drain_queue(self, block: bool) -> bool:
        """Move queued requests to the waiting list; False on the stop
        sentinel."""
        try:
            item = self._queue.get(timeout=0.05) if block else self._queue.get_nowait()
        except queue.Empty:
            return True
        while True:
            if item is None:
                return False
            if item.future.set_running_or_notify_cancel():
                self._waiting.append(item)
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return True

    def _plan_admissions(self) -> list:
        """Rank 0: waiting requests admitted into free slots, a chunk of up
        to ``prefill_chunk`` at a time, each in one data rank's slots (at
        most two chunks staged a data rank); their slots are taken here and
        the chunks featurized and prefilled by their data rank when the plan
        runs. Returns [(data rank, requests, global slots)]."""
        now = time.monotonic()
        live = []
        n_expired = 0
        # viability gate: a request whose REMAINING deadline is under the
        # measured service time (EWMA of slotted->finished) would only
        # expire mid-decode after taking slot steps; shed it while queued
        # (the JAX engine's gate, lock-out included: ROADMAP C)
        min_left = self._service_ewma
        for r in self._waiting:
            if r.deadline and r.deadline - now < min_left:
                self._record(r, "expired")
                r.future.set_exception(TimeoutError(
                    "deadline exceeded while queued" if r.deadline < now
                    else f"deadline cannot be met: {r.deadline - now:.2f}s left < "
                         f"{min_left:.2f}s estimated service time"))
                n_expired += 1
            else:
                live.append(r)
        if n_expired:
            with self._stats_lock:
                self._expired += n_expired
        self._waiting = live
        chunks, admitted = [], True
        while self._waiting and admitted:
            admitted = False
            for d in range(self._dp):
                free = [s for s in self._free if s // self.S_local == d]
                if not self._waiting or not free or len(self._staged_slots[d]) >= 2:
                    continue
                take = min(len(self._waiting), len(free), self.C)
                reqs, self._waiting = self._waiting[:take], self._waiting[take:]
                slots = free[-take:][::-1]
                for s in slots:
                    self._free.remove(s)
                self._staged_slots[d].append(slots)
                t_ins = time.monotonic()
                for s, r in zip(slots, reqs):
                    r.t_slotted = t_ins
                    self._slot_req[s] = r
                    self._slot_toks[s] = []
                    self._slot_lps[s] = []
                chunks.append((d, reqs, slots))
                admitted = True
        return chunks

    def _stage(self, keys: list, slots: List[int]) -> None:
        """This data rank: featurize and prefill a planned chunk (the
        attention kernels launch here) and stage it for a later dispatch.
        A chunk that does not featurize stages the dummy one instead (into
        the trash slot, so every rank keeps one order of staged chunks); its
        slots' error goes back to rank 0 with the next dispatch."""
        local = [s % self.S_local for s in slots]
        try:
            mb = self._chunk_batch([_Request(i, q) for i, q in keys])
        except Exception as e:
            log.warning(f"featurization of {len(keys)} requests failed: {e!r}")
            self._stage_errors.update({s: e for s in slots})
            self._staged.append(self._dummy + ([],))
            return
        with self._watchdog.guard("prefill dispatch"):
            cache, _, enc_mask, src = self._prefill(mb)
        self._staged.append((cache, enc_mask, src, local))
        with self._stats_lock:
            self._prefills += 1

    def _fail_slot(self, s: int, exc: Exception) -> None:
        """A slot whose chunk did not featurize: its request fails; the slot
        is free again once its (dummy) chunk has left the staging order."""
        req = self._slot_req[s]
        self._slot_req[s] = None
        if req is not None:
            self._record(req, "error", error=repr(exc))
            fail_future(req.future, exc)
            with self._stats_lock:
                self._failed += 1
        if self._live[s]:
            self._live[s] = False
            self._free.append(s)

    def _finish_slot(self, s: int):
        self._live[s] = False
        req = self._slot_req[s]
        toks = self._slot_toks[s]
        lps = self._slot_lps[s]
        # the greedy decode's row shape: [bos] + emissions + pad (token ids,
        # or component triples for the phoneme families)
        if self._ncomp == 1:
            row = [self._bos] + toks
            row += [self._pad] * (self.max_answer_length - len(row))
        else:
            row = [[self._bos] * self._ncomp] + toks
            row += [[self._pad] * self._ncomp] * (self.max_answer_length - len(row))
        try:
            answer = self.executor._decode_rows([row])[0]
        except Exception as e:
            self._record(req, "error", error=repr(e))
            req.future.set_exception(e)
            with self._stats_lock:
                self._failed += 1
        else:
            if self.confidence:
                # greedy's with_scores meaning: exp(mean chosen log-prob over
                # the emitted component ids, EOS included); each lps entry is
                # already summed over the step's components
                score = sum(lps) / max(len(lps) * self._ncomp, 1)
                answer = {"answer": answer, "confidence": round(math.exp(score), 4)}
            self._record(req, "ok",
                         answer_chars=len(answer["answer"] if self.confidence else answer),
                         decode_tokens=len(toks))
            req.future.set_result(answer)
            if req.t_slotted is not None:
                dt = time.monotonic() - req.t_slotted
                self._service_ewma = (dt if not self._service_ewma
                                      else 0.25 * dt + 0.75 * self._service_ewma)
            with self._stats_lock:
                self._served += 1
                self._latencies_ms.append((time.monotonic() - req.t_submit) * 1e3)
                del self._latencies_ms[:-10000]
                if self._cache_size:
                    self._cache[(req.image_id, req.question)] = answer
                    while len(self._cache) > self._cache_size:
                        self._cache.pop(next(iter(self._cache)))
        self._slot_req[s] = None
        self._slot_toks[s] = []
        self._slot_lps[s] = []
        self._free.append(s)

    def _expire_slot(self, s: int) -> None:
        """Deadline passed MID-DECODE: resolve the slotted request with
        TimeoutError, free the slot, and queue its device deactivation for
        the next dispatch (the kill mask)."""
        req = self._slot_req[s]
        self._live[s] = False
        self._slot_req[s] = None
        self._slot_toks[s] = []
        self._slot_lps[s] = []
        self._free.append(s)
        self._kill_pending.add(s)
        self._record(req, "expired", in_flight=True)
        fail_future(req.future, TimeoutError("deadline exceeded mid-decode"))
        with self._stats_lock:
            self._expired += 1

    def _run(self):
        self._stream.enter()
        try:
            self._run_inner()
        except Exception as e:
            # a raising dispatch (lost device, OOM, a dead follower): fail
            # everything in flight and flip unhealthy instead of hanging
            # every client
            self._fail_inflight(e)
        if self._link is not None and self._unhealthy is None:
            try:
                self._link.send({"op": "stop"})
            except Exception as e:
                self._fail_inflight(e)

    def _run_inner(self):
        running = True
        heartbeat = self._link.timeout_s / 4 if self._link is not None else None
        last_sent = time.monotonic()
        while True:
            if self._unhealthy is not None:
                return  # _fail_inflight already resolved everything
            staged = any(self._staged_slots)
            busy = any(self._slot_req) or self._waiting or staged
            if not running and not busy:
                if self._reload_req is not None:  # fail a reload caught by stop
                    _, ev, err = self._reload_req
                    err.append(RuntimeError("engine stopped during reload"))
                    self._reload_req = None
                    ev.set()
                return
            # block only when fully idle; otherwise just drain what is there
            if running:
                running = self._drain_queue(block=not busy)
            # mid-decode deadlines at the dispatch boundary: expire BEFORE
            # admission so a freed slot is immediately reusable
            now = time.monotonic()
            for s in range(self.S):
                req = self._slot_req[s]
                if self._live[s] and req is not None and req.deadline and req.deadline < now:
                    self._expire_slot(s)
            plan = {"op": "plan", "reload": None, "chunks": [], "dispatch": False, "kill": {}}
            if self._reload_req is not None and not any(self._slot_req) and not staged:
                # drain barrier reached: no slot decodes under mixed weights
                plan["reload"] = self._reload_req[0]
            if self._reload_req is None or plan["reload"] is not None:
                chunks = self._plan_admissions()
                plan["chunks"] = [(d, [(r.image_id, r.question) for r in reqs], slots)
                                  for d, reqs, slots in chunks]
            # else: admission paused; live slots keep draining below
            live = [s for s in range(self.S) if self._live[s] and self._slot_req[s] is not None]
            if live or any(self._staged_slots) or self._kill_pending:
                plan["dispatch"] = True
                for q in self._staged_slots:  # each data rank scatters its first staged chunk
                    for s in q.pop(0) if q else ():
                        if self._slot_req[s] is None:  # its chunk failed: free it now
                            self._free.append(s)
                        else:
                            self._live[s] = True
                for s in self._kill_pending:
                    plan["kill"].setdefault(s // self.S_local, []).append(s % self.S_local)
                self._kill_pending.clear()
            elif plan["reload"] is None and not plan["chunks"]:
                if heartbeat is not None and time.monotonic() - last_sent > heartbeat:
                    with self._watchdog.guard("mesh heartbeat"):
                        self._link.send({"op": "noop"})
                    last_sent = time.monotonic()
                continue
            if self._state is None:  # warmup=False on the CPU: built at first use
                self._warmup()
            if self._link is not None:
                with self._watchdog.guard("mesh send"):
                    self._link.send(plan)
                last_sent = time.monotonic()
            out = self._execute(plan)
            if plan["reload"] is not None:
                _, ev, err = self._reload_req
                if out["reload_error"] is not None:
                    err.append(out["reload_error"])
                self._reload_req = None
                ev.set()
            if not plan["dispatch"]:
                continue
            if self._unhealthy is not None:
                return  # the stall fired while blocked; futures already failed
            for s, e in out["errors"].items():
                self._fail_slot(s, e if isinstance(e, BaseException) else RuntimeError(e))
            live = [s for s in range(self.S) if self._live[s] and self._slot_req[s] is not None]
            with self._stats_lock:
                self._dispatches += 1
                self._slot_steps += len(live) * self.horizon
                self._total_steps += self.S * self.horizon
            self._collect_tokens(live, *out["tokens"])

    def _execute(self, plan: dict) -> dict:
        """Every rank: one plan's device work, in one order: the reload, the
        chunks this data rank prefills, the dispatch. Returns
        ``{"reload_error"}`` and, after a dispatch, ``"tokens"`` (the
        horizon's tokens, log-probs and accepted counts of every slot, on
        rank 0 gathered over the data axis) and ``"errors"`` (global slot
        -> why its chunk did not featurize)."""
        out = {"reload_error": None}
        if plan["reload"] is not None:
            out["reload_error"] = self._reload_weights(plan["reload"])
        for d, keys, slots in plan["chunks"]:
            if d == self._dp_rank:
                self._stage(keys, slots)
        if not plan["dispatch"]:
            return out
        staged = self._staged.pop(0) if self._staged else None
        t0 = time.perf_counter()
        with self._watchdog.guard("decode dispatch"):
            tokens = self._dispatch(staged, plan["kill"].get(self._dp_rank, []))
        self._dispatch_s += time.perf_counter() - t0
        errors, self._stage_errors = self._stage_errors, {}
        if self._mesh is not None and self._dp > 1:
            parts = self._link.gather(self._mesh, (tokens, {s: repr(e)
                                                            for s, e in errors.items()}))
            tokens = tuple(None if parts[0][0][k] is None
                           else np.concatenate([p[0][k] for p in parts], axis=1)
                           for k in range(3))
            errors = {s: e for p in parts for s, e in p[1].items()}
        out.update(tokens=tokens, errors=errors)
        return out

    def follow(self) -> None:
        """The loop of a rank other than 0 in a serving mesh: it applies rank
        0's plans in order (:meth:`_execute`) until rank 0's stop. A failed
        collective raises: the mesh is broken."""
        if self._leader:
            raise RuntimeError("follow() runs on the ranks of a mesh other than 0")
        self._stream.enter()
        while True:
            plan = self._link.recv()
            if plan["op"] == "stop":
                break
            if plan["op"] == "plan":
                self._execute(plan)
                if plan["dispatch"]:
                    with self._stats_lock:
                        self._dispatches += 1
        self._close_graph()
        self._watchdog.close()

    def _collect_tokens(self, live, toks_np, lps_np, neff_np) -> None:
        """The horizon's tokens into the live slots' rows; a slot finishes at
        its EOS (the onset's, for triples) or at max_answer_length - 1
        emissions, as the device's active flags do."""
        spec_emitted = spec_steps = 0
        for step in range(self.horizon):
            for s in live:
                if self._slot_req[s] is None or not self._live[s]:
                    continue
                if neff_np is not None:
                    # speculative: 0..K accepted tokens this device step
                    spec_steps += 1
                    for j in range(int(neff_np[step, s])):
                        t = int(toks_np[step, s, j])
                        self._slot_toks[s].append(t)
                        self._slot_lps[s].append(float(lps_np[step, s, j]))
                        spec_emitted += 1
                        if t == self._eos or len(self._slot_toks[s]) >= \
                                self.max_answer_length - 1:
                            self._finish_slot(s)
                            break
                    continue
                if self._ncomp == 1:
                    t = int(toks_np[step, s])
                    stop = t == self._eos
                else:
                    t = [int(c) for c in toks_np[step, s]]
                    stop = t[0] == self._eos  # the onset's EOS ends the row
                self._slot_toks[s].append(t)
                self._slot_lps[s].append(float(lps_np[step, s]))
                if stop or len(self._slot_toks[s]) >= self.max_answer_length - 1:
                    self._finish_slot(s)
        if spec_steps:
            with self._stats_lock:
                self._spec_tokens += spec_emitted
                self._spec_steps += spec_steps
