"""Dynamic-batching serving engine over an executor's decode path
(counterpart of ``phoneme_vqa_tpu/serving/engine.py``).

* **One captured decode serves all traffic.** Requests are gathered into
  fixed batch shapes (buckets; a partial batch is padded), and on the card
  each bucket's greedy decode is a set of CUDA graphs captured at warmup
  (``serving/graphs.py``): replays, no per-step kernel launches from
  Python. On the CPU the same operations run eagerly.
* **Dynamic batching.** A lone request waits at most ``max_wait_ms`` for
  batch-mates; under load the batch fills to ``batch_size``.
* **Featurization rides the data layer.** Each batch of requests becomes QA
  rows featurized against the preloaded OCR (and object) stores by the
  executor's own ``_make_dataset``: the arrays the eval path produces.
* **Two threads.** The dispatcher gathers, featurizes, moves a batch to the
  device and launches its encode; the resolver replays the decode, reads
  the rows back and resolves the futures. A handoff queue of depth 2
  between them lets featurizing batch i+1 overlap the decode of batch i.
  On the card both threads run on the engine's own stream.
* **Tracing** (``utils/profiling.py``, recorded while a ``torch.profiler``
  session runs): each gathered batch takes an id that every span of it
  carries. The dispatcher's spans are ``engine.collect``,
  ``engine.featurize``, ``engine.encode`` and ``engine.handoff``, and one
  ``engine.queue`` a request (submit to claim); the resolver's tile its
  loop: ``engine.await_batch``, ``decode.replay`` (with a ``decode.sync``
  for each all-done read), ``decode.readback``, ``engine.detokenize``,
  ``engine.complete``. ``stats()`` counts always: ``queue_wait_s`` over
  ``claimed`` requests is the mean wait from submit to the dispatcher's
  claim; ``decode_s`` the resolver's graph replays, read-back and
  detokenize.

Works with any executor family (LaTr / PreSTU / SaL x stock / customized /
phoneme): the engine uses ``executor._make_dataset``, ``infer_async`` (or
``infer``) and, for the graphs, ``executor.model``. Feature stores are the
port's dicts keyed by image id (``data/adapters.py``), not frames.

* **Adapters.** Several LoRA fine-tunes served off one base model: a
  request names its adapter, requests are grouped by adapter, and a switch
  writes the merged weights into the parameters' own storage (the graphs
  read them in place) after the batches in flight have drained. The base
  is restored from a kept copy of the adapted leaves, never by subtraction.
* **ViT encoding cache** (``VIT_CACHE``, ``serving/encoding_cache.py``):
  an image seen before skips the ViT.
* **The decode** (``stats()["decode"]`` names it, with the reason): a
  greedy config replays its bucket's CUDA graphs ("graphs"); ``SAMPLE`` and
  beam search (``isgreedy: false``) run the executor's eager generate
  ("eager"), on the card as on the CPU, the encode still through the
  kernels.

Over a mesh (an executor built in a ``torch.distributed`` group with a
``MESH``; ``torchrun --nproc-per-node N -m phoneme_vqa_torch.serve ...``): the
engine is built on every rank. Rank 0 alone holds the queue, the deadlines,
the cache and the front end; for each batch its dispatcher broadcasts one
small message (the batch's (image_id, question) keys, its adapter and its
bucket) over a gloo group of the engine's own (:class:`ControlLink`, on the
CPU whatever the data backend), and so do reloads and the stop. The other
ranks run :meth:`ServingEngine.follow`, which has no queue: each message is
applied at the same batch boundary on every rank. A bucket is a multiple of
the data axis; each data rank featurizes and decodes its block of the
bucket's rows (``parallel/mesh.py: serve_rows``), the model ranks of a data
rank together, and the answers come back to rank 0 over a second gloo
group of the link's (one group a thread of rank 0's, so each group's
operations keep one order on every rank). A batch's encode and decode, and
so every collective of the model axis, run in the resolver's ``resolve``
alone (rank 0's resolver thread, a follower's loop), one batch after the
other: every rank issues them in one order. The decode follows
:func:`captured_decode`: each rank captures its own graphs at its share of
each bucket (``bucket / data`` rows) at warmup, in bucket order, so every
model rank captures together; at model 1 the decode holds no collective,
and over NCCL at model > 1 the model axis's collectives are captured inside
the graphs. Over gloo at model > 1 nothing is captured (gloo's collectives
go through the host) and the graph decoder's chunks run uncaptured;
``stats()`` and the log name the decode. Rank 0 broadcasts a no-op after
``group_timeout_s / 4`` seconds idle, so a follower that died fails its
next collective within ``group_timeout_s``: the engine turns unhealthy.
"""

from __future__ import annotations

import contextlib
import itertools
import math
import queue
import threading
import time
from concurrent.futures import Future
from datetime import timedelta
from typing import List, Optional

import torch
import torch.distributed as dist

from ..data.loader import batch_iterator
from ..parallel.mesh import serve_rows
from ..utils import profiling
from ..utils.logger import get_logger
from .encoding_cache import EncodingCache
from .graphs import GraphDecoder, check_params_in_place, param_addresses
from .watchdog import StallWatchdog, fail_future

log = get_logger(__name__)


class _Request:
    __slots__ = ("image_id", "question", "future", "t_submit", "deadline", "adapter",
                 "t_slotted")

    def __init__(self, image_id, question, deadline=None, adapter=None):
        self.image_id = image_id
        self.question = question
        self.future: Future = Future()
        self.t_submit = time.monotonic()
        self.deadline = deadline  # absolute monotonic time, or None
        self.adapter = adapter
        self.t_slotted = None  # when device work started (EWMA input)


def featurize_requests(executor, ocr_store, obj_store, reqs: List[_Request]):
    """Requests -> the executor's own eval-path dataset: QA rows (answers
    empty: serving has none) featurized against the preloaded stores by
    ``_make_dataset``. Rows whose image a store lacks are dropped."""
    rows = [{"image_id": r.image_id, "question": r.question, "answer": ""} for r in reqs]
    if obj_store is not None:
        return executor._make_dataset(rows, ocr_store, obj_store)
    return executor._make_dataset(rows, ocr_store)


def decode_rows(tokenizer, rows) -> List[str]:
    """Cut [start, ..., eos] to the tokens between, then detokenize."""
    eos = tokenizer.eos_token_id
    cut = []
    for row in rows:
        try:
            cut.append(row[1 : row.index(eos)])
        except ValueError:
            cut.append(row)
    return tokenizer.batch_decode(cut, skip_special_tokens=True)


def decode_answer_rows(answer_tokenizer, rows) -> List[str]:
    """Detokenize rows with an answer tokenizer, which cuts them itself (the
    char and byte tokenizers at EOS; the flat phoneme tokenizer drops its
    special ids and recomposes the syllables; the structured one reads (T, 3)
    triple rows up to the onset's EOS). The char and byte tokenizers return
    one-element lists."""
    decoded = answer_tokenizer.batch_decode(rows)
    return [d[0] if isinstance(d, list) else d for d in decoded]


def store_key_type(store: dict):
    """The numeric type of a store's image ids (int or float), or None."""
    key = next(iter(store), None)
    if isinstance(key, bool):
        return None
    if isinstance(key, int):
        return int
    if isinstance(key, float):
        return float
    return None


def coerce_image_id(image_id, key_type):
    """``image_id`` as the store's key type when the value survives the round
    trip (JSON clients send "3" or 3 for a store keyed by 3.0; int(3.7)
    would answer for the wrong image, so it is left as it is and rejected)."""
    if key_type is None:
        return image_id
    try:
        coerced = key_type(float(image_id)) if key_type is int else key_type(image_id)
        if float(coerced) == float(image_id):
            return coerced
    except (TypeError, ValueError, OverflowError):
        pass
    return image_id


def engine_device(executor):
    """The executor's device, or None for an executor without one (stubs)."""
    device = getattr(executor, "device", None)
    return None if device is None else torch.device(device)


def decodes_with_graphs(executor) -> bool:
    """Whether the engine decodes ``executor``'s model through
    ``serving/graphs.py``: a real executor whose configured decode is greedy
    (``SPEC_DECODE`` and ``EVAL_CONTINUOUS`` give greedy's rows). Sampling
    and beam search have no graphs: the engine serves them through the
    executor's eager generate, on the CPU and on the card alike."""
    return (hasattr(executor, "model") and hasattr(executor, "_decodes_greedy")
            and bool(executor._decodes_greedy()))


def captured_decode(device, mesh=None, what: str = "each bucket's decode") -> tuple:
    """(whether ``what`` is captured in CUDA graphs, the decode's name and
    why) for a greedy decode on ``device`` over ``mesh`` (None: one
    process): the rule both engines follow, decided before warmup from the
    mesh's backend and its model axis. Over gloo at model > 1 nothing is
    captured: gloo's collectives go through the host. Off the card the
    same operations run eagerly. Otherwise each process captures its own
    graphs: at model 1 they hold no collective, over NCCL at model > 1 the
    model axis's collectives are captured inside."""
    if mesh is not None and mesh.tp > 1 and mesh.backend != "nccl":
        return False, (f"eager: over {mesh.backend} at model {mesh.tp} {what} is not captured "
                       "(gloo's collectives go through the host, outside any CUDA graph); the "
                       "same operations run uncaptured")
    if device is None or device.type != "cuda":
        return False, f"graphs: {what} runs the captured operations eagerly, off the card"
    if mesh is None:
        return True, f"graphs: {what} replayed from its CUDA graphs"
    if mesh.tp == 1:
        return True, (f"graphs: {what} replayed from the CUDA graphs each data rank captures for "
                      "its rows (model 1: no collective inside)")
    return True, (f"graphs: {what} replayed from CUDA graphs with the model axis's NCCL "
                  "collectives captured inside")


def decode_mode(executor, mesh=None, eager: bool = False) -> tuple:
    """(whether the engine decodes through the graph decoder, whether it
    captures the decoder's chunks in CUDA graphs, the decode's name and
    why): what ``stats()["decode"]`` reports. ``eager``: the executor's
    eager generate even where the graphs would serve (a yardstick)."""
    if not decodes_with_graphs(executor):
        if not hasattr(executor, "model"):
            return False, False, "eager: the executor decodes in its own infer"
        return False, False, ("eager: SAMPLE and beam search have no captured graphs; the "
                              "executor's generate runs eagerly, its encode through the kernels")
    if eager:
        return False, False, ("eager: asked for (eager_decode); the executor's generate, its "
                              "encode through the kernels")
    return (True, *captured_decode(engine_device(executor), mesh))


def warm_model_group(mesh) -> None:
    """One all-reduce on the model axis's group, on the current stream.
    Over NCCL a group's communicator is made at its first collective,
    which must not fall inside a capture: every rank calls this before its
    first one."""
    if mesh is not None and mesh.tp > 1:
        dist.all_reduce(torch.zeros(1, device=torch.cuda.current_device()), group=mesh.tp_group)


def serving_mesh(executor):
    """The executor's mesh when it spans more than one process, else None."""
    mesh = getattr(executor, "mesh", None)
    if mesh is None or not dist.is_initialized() or dist.get_world_size() == 1:
        return None
    return mesh


class ControlLink:
    """Rank 0's channel to the other ranks of a serving mesh: small pickled
    messages broadcast over a gloo group of its own (on the CPU, whatever
    the data backend: an idle follower waits in it, and a CPU wait has no
    device watchdog), sent one at a time in the order rank 0 sends them.
    Every rank builds it with :func:`control_link`, at the same point."""

    def __init__(self, timeout_s: float):
        self.timeout_s = float(timeout_s)
        timeout = timedelta(seconds=self.timeout_s)
        self.group = dist.new_group(backend="gloo", timeout=timeout)
        # the answers' gathers: rank 0's resolver issues them while its
        # dispatcher broadcasts on ``group``, so they need a group of their own
        self.data_group = dist.new_group(backend="gloo", timeout=timeout)
        self._lock = threading.Lock()

    def send(self, message: dict) -> None:
        with self._lock:
            dist.broadcast_object_list([message], src=0, group=self.group)

    def recv(self) -> dict:
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.group)

    def gather(self, mesh, payload) -> list:
        """Every data rank's ``payload`` (its first model rank's), in data
        rank order, on every rank: an all-gather over the world on the
        link's data group."""
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, (mesh.dp_rank, mesh.tp_rank, payload),
                               group=self.data_group)
        return [p for _, _, p in sorted(x for x in parts if x[1] == 0)]


_LINK: Optional[ControlLink] = None

#: the timeout of a serving mesh's collectives, seconds (the serve CLI's
#: ``--group-timeout``): a follower that died fails rank 0's next
#: collective within it
GROUP_TIMEOUT_S = 120.0


def control_link(timeout_s: float = GROUP_TIMEOUT_S) -> ControlLink:
    """This process's :class:`ControlLink`, built at the first call (a
    collective: every rank makes its first call at the same point). A later
    call that asks for another timeout raises: the link keeps its first."""
    global _LINK
    if _LINK is None:
        _LINK = ControlLink(timeout_s)
    elif float(timeout_s) != _LINK.timeout_s:
        raise ValueError(f"the serving mesh's control link has a {_LINK.timeout_s} s group "
                         f"timeout; an engine asked for {float(timeout_s)} s")
    return _LINK


class _BatchError(RuntimeError):
    """A served batch failed on some rank before any collective (its rows
    did not featurize): its requests fail, the mesh stays in step."""


class DeviceStream:
    """The engine's own CUDA stream on the executor's device (a no-op off
    the card): ``enter()`` makes it, and the device, current in the calling
    thread; ``scope()`` does so for a block."""

    def __init__(self, device):
        self.device = device
        self.stream = None
        if device is not None and device.type == "cuda":
            if device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self.stream = torch.cuda.Stream(self.device)

    def enter(self) -> None:
        if self.stream is not None:
            torch.cuda.set_device(self.device)
            torch.cuda.set_stream(self.stream)

    def scope(self):
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def synchronize(self) -> None:
        if self.stream is not None:
            torch.cuda.synchronize(self.device)


class ServingEngine:
    """Batches concurrent answer requests through ``executor.infer_async``.

    Parameters
    ----------
    executor: a constructed executor (any mode) with weights in place:
        e.g. built by ``serve.py`` in serve mode with the best checkpoint
        loaded, or a train-mode executor in tests.
    ocr_store: the OCR feature store (``textlayout_ocr_adapt``).
    obj_store: the object feature store (SaL family only).
    batch_size: the largest decode batch shape.
    max_wait_ms: max time a lone request waits for batch-mates.
    max_answer_length: decode length cap.
    warmup: decode every bucket once at construction, not on the first
        request. On the card each bucket's graphs are captured at
        construction whatever ``warmup`` says: capturing on the engine's
        stream while the resolver replays there would record the replay.
    max_queue: >0 bounds pending requests; submit raises when full.
        **-1 derives a bound (4 x batch_size).** A bound below 2 x
        batch_size STARVES the batcher: the queue can never hold a full
        batch plus arrivals, so batches run partial and goodput collapses
        below capacity; a loud warning is logged. 0 = unbounded.
    cache_size: >0 memoizes up to that many (image_id, question) -> answer
        pairs (LRU). Decode is deterministic and weights only change through
        :meth:`reload` (which clears the cache).
    confidence: resolve requests to ``{"answer", "confidence"}`` dicts:
        exp of the answer's mean emitted-token log-probability, computed in
        the same decode (``executor.infer(return_scores=True)``).
    default_deadline_s: >0 gives every request a deadline that many seconds
        after submission. A request whose deadline passes while it waits is
        EXPIRED before featurization (TimeoutError); so is one whose
        remaining time is under the measured service time (an EWMA of
        claim -> resolve). ``deadline_s`` on :meth:`submit` overrides.
    adapters: ``{name: {"lora": adapters, "scale": float}}`` (``train/lora.py``
        adapters, e.g. from ``serve.load_adapter``): several LoRA fine-tunes
        served off one base model. A request naming an adapter decodes with
        ``base + scale * (A @ B)^T``; requests are grouped by adapter within
        each gathered batch, and a switch waits for the batches in flight,
        then writes the merged weights into the parameters in place (the
        base is kept as an f32 copy of the adapted leaves, and restored from
        it bit for bit). Adapters are checked against the base at
        construction (another family's fails fast).
    buckets: ascending decode batch shapes (e.g. ``[1, 4]``) warmed up
        beside ``batch_size``; each gathered batch decodes at the smallest
        bucket that fits. Default: ``[batch_size]``.
    access_log: callable receiving one dict per resolved request (``ok``
        with the bucket and answer length, ``cached``, ``expired``,
        ``error``; each with its submit -> resolution latency). The question
        text is never logged, only its length. A sink that raises is
        disabled after one warning.
    stall_timeout_s: a device call blocking longer than this fails every
        in-flight future, marks the engine unhealthy and keeps ``stop()``
        returning (``serving/watchdog.py``). 0 disables.
    group_timeout_s: over a mesh, the timeout of the engine's control
        group; rank 0 sends a no-op after a quarter of it idle (module
        docstring). Build every rank's engine with the same arguments.
    eager_decode: decode through the executor's eager generate even where
        the graph decoder would serve (``stats()`` names it): the yardstick
        the graphs are timed against.
    """

    def __init__(
        self,
        executor,
        ocr_store: dict,
        obj_store: Optional[dict] = None,
        batch_size: int = 8,
        max_wait_ms: float = 5.0,
        max_answer_length: int = 20,
        warmup: bool = True,
        max_queue: int = 0,
        cache_size: int = 0,
        confidence: bool = False,
        default_deadline_s: float = 0.0,
        adapters: Optional[dict] = None,
        buckets: Optional[list] = None,
        access_log=None,
        stall_timeout_s: float = 300.0,
        group_timeout_s: float = GROUP_TIMEOUT_S,
        eager_decode: bool = False,
    ):
        self.executor = executor
        self.ocr_store = ocr_store
        self.obj_store = obj_store
        self.batch_size = int(batch_size)
        self._mesh = serving_mesh(executor)
        self._link = control_link(group_timeout_s) if self._mesh is not None else None
        self._leader = self._mesh is None or dist.get_rank() == 0
        self.buckets = self._resolve_buckets(buckets)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_answer_length = int(max_answer_length)
        self.confidence = bool(confidence)
        self.default_deadline_s = float(default_deadline_s)
        self._key_type = store_key_type(ocr_store)
        self._known_ids = set(ocr_store)
        if obj_store is not None:
            # SaL family: featurization inner-joins BOTH stores; admit only
            # images present in each, or one bad request would fail its
            # whole batch at the dropped-rows check
            self._known_ids &= set(obj_store)
        if not self._known_ids:
            raise ValueError(
                "feature store is empty (no image ids"
                + (" present in both OCR and object stores)" if obj_store is not None
                   else " in the OCR store)"))
        if max_queue < 0:
            max_queue = 4 * self.batch_size
        elif 0 < max_queue < 2 * self.batch_size:
            log.warning(
                f"(!) max_queue={max_queue} < 2*batch_size={2 * self.batch_size} STARVES the "
                "batcher: the queue can never hold a full batch plus arrivals, so decodes run "
                f"partial and goodput collapses below capacity. Use >= {2 * self.batch_size} "
                f"(or -1 to auto-derive {4 * self.batch_size}).")
        self.max_queue = max_queue
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(maxsize=max_queue)
        self._stopped = False
        self._unhealthy: Optional[str] = None
        self._watchdog = StallWatchdog(stall_timeout_s, self._on_stall)
        self._inflight_reqs: set = set()  # claimed by the dispatcher,
        self._inflight_lock = threading.Lock()  # unresolved by the resolver
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._swap_lock = threading.Lock()  # one reload at a time
        # reload barrier: batches between dispatch and resolution, and
        # whether a reload waits for them to drain (the dispatcher holds new
        # batches meanwhile: no batch decodes under a mix of weights)
        self._weights_cv = threading.Condition()
        self._batches_in_flight = 0
        self._reload_waiting = False
        self._served = 0
        self._failed = 0
        self._service_ewma = 0.0  # claim->resolve seconds, viability gate
        self._batches = 0
        self._cache_hits = 0
        self._reloads = 0
        self._expired = 0
        self._latencies_ms: list = []
        self._decode_s = 0.0  # seconds this rank spent decoding batches
        self._queue_wait_s = 0.0  # submit -> claim, summed over claimed requests
        self._claimed = 0
        self._batch_ids = itertools.count()
        self._cache_size = int(cache_size)
        self._cache: dict = {}  # (image_id, question, adapter) -> answer
        self._bucket_batches: dict = {}  # decode batch shape -> count
        self._access_log = access_log
        self._adapters = dict(adapters or {})
        self._active_adapter = None
        self._adapter_switches = 0
        self._switch_ms: list = []
        self._base_copies: dict = {}  # adapted weight name -> f32 base
        if self._adapters:
            # here, not at import: the executors import this module
            from ..train import lora as lora_mod

            self._lora = lora_mod
            executor._ensure_params()
            named = dict(executor.model.named_parameters())
            for name, spec in self._adapters.items():
                if hasattr(executor, "_shard_lora"):  # a model rank's parts
                    spec = self._adapters[name] = dict(spec,
                                                       lora=executor._shard_lora(spec["lora"]))
                bad = self._lora.unmatched_adapter_paths(named, spec["lora"])
                if bad:
                    raise ValueError(f"adapter {name!r} does not match the served base model: "
                                     f"{len(bad)} unmatched kernel(s), e.g. {bad[:3]}: wrong "
                                     "family?")
            self._capture_base()
        # built before warmup: with the cache on, every batch's encode takes
        # the vit_encodings input
        self._enc_cache = EncodingCache.maybe_build(executor, self._adapters)
        self._stream = DeviceStream(engine_device(executor))
        profiling.watch_gc()
        self._graphs, self._captures, self.decode_reason = decode_mode(executor, self._mesh,
                                                                       eager_decode)
        if self._mesh is not None:
            log.info(f"## serving over a mesh ({self._mesh.describe()}), buckets {self.buckets}; "
                     f"decode {self.decode_reason}")
        self._decoders: dict = {}  # bucket -> GraphDecoder
        self._graph_pool = None
        self._param_addresses = None
        self.capture_s: dict = {}  # bucket -> seconds to capture its graphs
        if self._graphs:
            executor._ensure_params()
            self._param_addresses = param_addresses(executor.model)
        if self._captures:
            self._graph_pool = torch.cuda.graph_pool_handle()
            warmup = True
        if warmup:
            ds = self._featurize([self._dummy_request()])
            with self._stream.scope():
                if self._captures:
                    warm_model_group(self._mesh)
                for bucket in self.buckets:  # one order on every rank of a mesh
                    self._infer_async(ds, bucket)()
            self._stream.synchronize()
        self._inflight: "queue.Queue" = queue.Queue(maxsize=2)
        if not self._leader:  # a follower: no threads, follow() runs its loop
            return
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="serving-dispatcher")
        self._worker.start()
        self._resolver = threading.Thread(target=self._resolve_loop, daemon=True,
                                          name="serving-resolver")
        self._resolver.start()

    def _dummy_request(self) -> _Request:
        """A featurizable placeholder request (warmup)."""
        return _Request(next(iter(self._known_ids)), "")

    def _record(self, req: _Request, status: str, **extra) -> None:
        """One access-log record (no-op without a sink). A sink that raises
        is disabled after one warning, never crashes serving."""
        if self._access_log is None:
            return
        image_id = req.image_id
        rec = {
            "ts": round(time.time(), 3),
            "image_id": image_id.item() if hasattr(image_id, "item") else image_id,
            "question_chars": len(req.question),  # length only, never the text
            "adapter": req.adapter,
            "status": status,
            "latency_ms": round((time.monotonic() - req.t_submit) * 1e3, 3),
            **extra,
        }
        try:
            self._access_log(rec)
        except Exception as e:
            log.warning(f"(!) access-log sink raised {e!r}: access logging disabled")
            self._access_log = None

    def _resolve_buckets(self, buckets) -> list:
        """Ascending decode batch shapes ending at ``batch_size``. None keeps
        the single-shape engine. Each bucket is rounded up to a multiple of
        the mesh's data axis, so every data rank decodes an equal block,
        then clipped to ``batch_size`` and deduped; ``batch_size`` must
        divide the axis."""
        dp = self._data_axis()
        if self.batch_size % dp:
            raise ValueError(f"batch_size {self.batch_size} must divide the mesh's data axis "
                             f"({dp})")
        if not buckets:
            return [self.batch_size]
        out = set()
        for b in buckets:
            b = int(b)
            if b <= 0:
                raise ValueError(f"bucket sizes must be positive, got {b}")
            out.add(min(self.batch_size, -(-b // dp) * dp))
        out.add(self.batch_size)
        return sorted(out)

    def _data_axis(self) -> int:
        """The data axis of the executor's mesh (1 without one)."""
        mesh = getattr(self.executor, "mesh", None)
        return 1 if mesh is None else int(mesh.dp)

    # -- client surface -------------------------------------------------------

    def submit(self, image_id, question: str, deadline_s: float = None,
               adapter: str = None) -> Future:
        """Enqueue a request; resolves to the answer string (or the
        ``{"answer", "confidence"}`` dict in confidence mode). ``deadline_s``
        (or the engine's ``default_deadline_s``) expires the request with
        TimeoutError if it is still queued that many seconds from now."""
        if adapter is not None and adapter not in self._adapters:
            raise KeyError(f"unknown adapter {adapter!r} (serving "
                           f"{sorted(self._adapters) or 'base only'})")
        with self._lock:  # uniform admission: a stopped engine rejects
            if self._unhealthy is not None:  # everything, cache included
                raise RuntimeError(f"engine unhealthy: {self._unhealthy}")
            if self._stopped:
                raise RuntimeError("engine stopped")
        image_id = coerce_image_id(image_id, self._key_type)
        if image_id not in self._known_ids:
            stores = "OCR store" if self.obj_store is None else "OCR+object stores"
            raise KeyError(f"unknown image_id {image_id!r} (not in {stores})")
        if self._cache_size:
            key = (image_id, question, adapter)
            hit = object()  # sentinel: None is not a valid cached answer
            answer = hit
            with self._stats_lock:
                if key in self._cache:
                    answer = self._cache.pop(key)
                    self._cache[key] = answer  # move-to-end: LRU
                    self._cache_hits += 1
            if answer is not hit:
                self._record(_Request(image_id, question, adapter=adapter), "cached")
                fut: Future = Future()
                fut.set_result(answer)
                return fut
        if deadline_s is None and self.default_deadline_s > 0:
            deadline_s = self.default_deadline_s
        deadline = time.monotonic() + deadline_s if deadline_s else None
        req = _Request(image_id, question, deadline, adapter)
        with self._lock:  # pairs with stop(): no enqueue after the sentinel
            if self._unhealthy is not None:
                raise RuntimeError(f"engine unhealthy: {self._unhealthy}")
            if self._stopped:
                raise RuntimeError("engine stopped")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                raise RuntimeError(f"serving queue full ({self._queue.maxsize} pending)") from None
        return req.future

    def answer(self, image_id, question: str, timeout: Optional[float] = None,
               deadline_s: float = None, adapter: str = None) -> str:
        """Synchronous convenience wrapper around :meth:`submit`."""
        return self.submit(image_id, question, deadline_s=deadline_s,
                           adapter=adapter).result(timeout=timeout)

    def stats(self) -> dict:
        """Served/failed counts, batch count, queue depth, and request-latency
        percentiles (submit -> resolution, ms) over the last 10k requests;
        ``queue_wait_s`` is the submit -> claim wait summed over the
        ``claimed`` requests."""
        with self._inflight_lock:
            claims = {"queue_wait_s": self._queue_wait_s, "claimed": self._claimed}
        with self._stats_lock:
            lats = sorted(self._latencies_ms)
            pct = lambda p: lats[min(len(lats) - 1, int(p * len(lats)))] if lats else None  # noqa: E731
            return {
                "served": self._served,
                "failed": self._failed,
                "unhealthy": self._unhealthy,
                "decode": self.decode_reason.split(":")[0],
                "decode_reason": self.decode_reason,
                **({"mesh": self._mesh.describe()} if self._mesh is not None else {}),
                # chunks of decode steps run (the all-done exit is read after
                # each): every model rank of a data rank runs as many
                "decode_chunks": sum(d.chunks_run for d in list(self._decoders.values())),
                "batches": self._batches,
                "decode_s": self._decode_s,
                **claims,
                "cache_hits": self._cache_hits,
                "reloads": self._reloads,
                "expired": self._expired,
                "service_ewma_s": round(self._service_ewma, 3),
                "adapter_switches": self._adapter_switches,
                "bucket_batches": {str(k): v for k, v in sorted(self._bucket_batches.items())},
                "queue_depth": self._queue.qsize(),
                "p50_ms": pct(0.50),
                "p95_ms": pct(0.95),
                **({"adapter_switch_ms": list(self._switch_ms[-100:])} if self._adapters else {}),
                **({"vit_cache": self._enc_cache.stats()} if self._enc_cache is not None else {}),
            }

    def prometheus_metrics(self) -> str:
        """:meth:`stats` in the Prometheus text exposition format (served at
        ``GET /metrics`` by ``serve.py --http``)."""
        return prometheus_text(self.stats(), GATHERED_COUNTERS)

    def reload(self, loadtype: str = "best") -> dict:
        """Swap the serving weights for the ``loadtype`` checkpoint's. The
        dispatcher holds new batches while the ones in flight finish on the
        old weights; the checkpoint is then copied into the parameters' own
        storage (the captured graphs read it there) and serving resumes.
        The answer cache is cleared (its entries are stale under new
        weights)."""
        with self._lock:
            if self._stopped:
                raise RuntimeError("engine stopped")
        t0 = time.monotonic()
        with self._swap_lock:
            with self._weights_cv:
                self._reload_waiting = True
                try:
                    while self._batches_in_flight:
                        if self._unhealthy is not None:
                            raise RuntimeError(f"engine unhealthy: {self._unhealthy}")
                        self._weights_cv.wait(timeout=0.5)
                    if self._link is not None:  # every rank reloads at this boundary
                        self._link.send({"op": "reload", "loadtype": loadtype})
                    self._load_weights(loadtype)
                finally:
                    self._reload_waiting = False
                    self._weights_cv.notify_all()
        with self._stats_lock:
            self._cache.clear()
            self._reloads += 1
        ms = (time.monotonic() - t0) * 1e3
        log.info(f"## hot-reloaded {loadtype}_ckp in {ms:.0f} ms")
        return {"reloaded": loadtype, "ms": round(ms, 1)}

    def _load_weights(self, loadtype: str) -> None:
        """The checkpoint's weights into the parameters in place, with what
        they determine: the adapters' base and the encoding cache."""
        self.executor._load_trained_checkpoint(loadtype)
        self._stream.synchronize()
        if self._param_addresses is not None:
            check_params_in_place(self.executor.model, self._param_addresses)
        if self._adapters:  # the new weights are the base; adapters
            self._capture_base()  # re-merge at their next batch
            self._active_adapter = None
        if self._enc_cache is not None:  # the ViT may have changed
            self._enc_cache.flush()

    @property
    def unhealthy_reason(self) -> Optional[str]:
        """Non-None once the stall watchdog (or a fatal device error)
        declared the engine dead: ``/healthz`` turns 503."""
        return self._unhealthy

    def stop(self):
        """Drain outstanding requests, then stop both pipeline threads.
        ALWAYS returns: threads stuck on a dead device cannot be joined; once
        the watchdog declares the stall they are abandoned (daemons)."""
        with self._lock:
            already = self._stopped
            self._stopped = True
        if not self._leader:  # a follower stops at rank 0's stop message
            return
        if already and not (self._worker.is_alive() or self._resolver.is_alive()):
            return
        while self._worker.is_alive() or self._resolver.is_alive():
            try:
                self._queue.put_nowait(None)
            except queue.Full:
                pass  # the worker drains it (or is stuck: the watchdog decides)
            self._worker.join(timeout=0.5)
            if not self._worker.is_alive():
                self._resolver.join(timeout=0.5)
            if self._unhealthy:
                self._worker.join(timeout=1.0)
                self._resolver.join(timeout=1.0)
                if self._worker.is_alive() or self._resolver.is_alive():
                    log.warning("(!) stop(): abandoning pipeline thread(s) stuck on a dead "
                                "device (daemon threads)")
                break
        if not (self._worker.is_alive() or self._resolver.is_alive()):
            self._close_graphs()
        self._watchdog.close()

    def _close_graphs(self) -> None:
        """Close the graph decoders once no thread decodes
        (``GraphDecoder.close``: over NCCL, before the process group goes)."""
        self._stream.synchronize()
        for decoder in self._decoders.values():
            decoder.close()

    def _on_stall(self, label: str, waited: float) -> None:
        self._fail_inflight(RuntimeError(
            f"device stall: {label} blocked {waited:.0f}s (lost or hung card?)"))

    def _fail_inflight(self, exc: Exception) -> None:
        """Mark unhealthy and fail every claimed-but-unresolved and queued
        future with ``exc``. Idempotent; runs on the watchdog's monitor
        thread (pipeline threads stuck) or a pipeline thread (fatal error)."""
        with self._lock:
            if self._unhealthy is not None:
                return
            self._unhealthy = str(exc)
            self._stopped = True
        n = 0
        with self._inflight_lock:
            inflight = list(self._inflight_reqs)
            self._inflight_reqs.clear()
        for r in inflight:
            n += fail_future(r.future, exc)
        while True:  # queued but never claimed by the dispatcher
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                n += fail_future(item.future, exc)
        with self._stats_lock:
            self._failed += n
        with self._weights_cv:  # a reload waiting on the barrier gives up
            self._weights_cv.notify_all()
        log.error(f"(!!) engine unhealthy ({exc}): failed {n} in-flight request(s); "
                  "submits now reject")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    # -- adapters ---------------------------------------------------------------

    def _capture_base(self) -> None:
        """An f32 copy of the base of every leaf an adapter targets: the
        executor's f32 masters (a bf16 weight's own values are their
        rounding)."""
        masters = self.executor.state.params
        names = {n for spec in self._adapters.values() for n in spec["lora"]}
        self._base_copies = {n: masters[n].detach().float().clone() for n in names}

    @torch.no_grad()
    def _activate(self, adapter) -> None:
        """Put ``adapter``'s weights (None: the base) into the parameters'
        storage, unless they are there already. Runs on the dispatcher under
        the swap lock (reload takes it too), after the batches in flight have
        decoded: their graphs read these parameters in place. The merge has
        the rounding of the JAX package's ``merge_lora`` (f32 base + scale *
        f32 product), then the parameter's dtype: what a merged checkpoint
        served with no adapter holds. The base comes back from its f32 copy,
        bit for bit."""
        if not self._adapters:
            return
        with self._swap_lock:
            if adapter == self._active_adapter:
                return
            with self._weights_cv:
                while self._batches_in_flight:
                    if self._unhealthy is not None:
                        raise RuntimeError(f"engine unhealthy: {self._unhealthy}")
                    self._weights_cv.wait(timeout=0.5)
            t0 = time.perf_counter()  # the switch itself, after the drain
            with self._stream.scope():
                spec = self._adapters.get(adapter)
                for name, base in self._base_copies.items():
                    p = self.executor.model.get_parameter(name)
                    if spec is not None and name in spec["lora"]:
                        p.copy_(self._lora.merged_weight(base, spec["lora"][name],
                                                         spec["scale"]))
                    else:
                        p.copy_(base)
            self._stream.synchronize()
            self._active_adapter = adapter
            ms = (time.perf_counter() - t0) * 1e3
        with self._stats_lock:
            self._adapter_switches += 1
            self._switch_ms.append(ms)

    # -- worker ---------------------------------------------------------------

    def _collect(self) -> List[_Request]:
        while True:
            try:
                item = (self._queue.get(timeout=self._link.timeout_s / 4) if self._link is not None
                        else self._queue.get())
                break
            except queue.Empty:  # idle over a mesh: a no-op finds a dead follower
                with self._watchdog.guard("mesh heartbeat"):
                    self._link.send({"op": "noop"})
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # re-signal shutdown after this batch
                break
            batch.append(nxt)
        return batch

    def _featurize(self, reqs: List[_Request], encode: bool = True):
        """The requests' dataset; with ``encode`` the cached ViT encodings
        applied (over a mesh the resolver applies them: a cache miss runs
        the ViT, whose collectives belong on the resolver's thread)."""
        ds = featurize_requests(self.executor, self.ocr_store, self.obj_store, reqs)
        if encode and self._enc_cache is not None:
            with self._stream.scope():
                self._enc_cache.apply(ds, [r.image_id for r in reqs])
        return ds

    def _decoder(self, dataset, bucket: int) -> GraphDecoder:
        """The bucket's graph decoder over this rank's rows of it (over a
        mesh ``bucket / data``), built at its first batch (on the card: at
        construction, on the engine's stream)."""
        if bucket not in self._decoders:
            rows = bucket // self._data_axis()
            batch, _ = next(batch_iterator(dataset, rows, pad_final=True))
            t0 = time.perf_counter()
            self._decoders[bucket] = GraphDecoder(
                self.executor.model, self.executor._device_batch(batch), self.max_answer_length,
                self.confidence, self._graph_pool, captured=self._captures)
            self._stream.synchronize()
            self.capture_s[bucket] = time.perf_counter() - t0
        return self._decoders[bucket]

    def _infer_async(self, dataset, bucket: int):
        """``executor.infer_async`` at ``bucket`` (through the bucket's graph
        decoder where the engine has one); a stub executor that has only
        ``infer`` answers at dispatch. Over a mesh, the decode of this rank's
        rows at its share of the bucket, encode included, run in the
        returned ``resolve`` with its collectives (:meth:`_mesh_batch`
        gathers the answers)."""
        infer_async = getattr(self.executor, "infer_async", None)
        if infer_async is None:
            answers = self.executor.infer(dataset, bucket, self.max_answer_length,
                                          return_scores=self.confidence)
            return lambda: answers
        if self._mesh is not None:
            rows = bucket // self._mesh.dp

            def run():  # on the resolver: one order of collectives on every rank
                kw = {"decoder": self._decoder(dataset, bucket)} if self._graphs else {}
                return infer_async(dataset, rows, self.max_answer_length,
                                   return_scores=self.confidence, local=True, **kw)()

            return run
        kw = {"decoder": self._decoder(dataset, bucket)} if self._graphs else {}
        return infer_async(dataset, bucket, self.max_answer_length,
                           return_scores=self.confidence, **kw)

    def _mesh_batch(self, keys: list, bucket: int):
        """This rank's part of a served batch over the mesh: its block of
        ``keys`` (``serve_rows``) featurized, a placeholder row where it has
        none (or where featurizing failed: the error travels with the
        answers, so every rank still steps the decode), and ``resolve()``,
        which decodes them and gathers the data ranks' answers in order
        (with the confidence scores), raising :class:`_BatchError` after the
        gather if some rank's rows did not featurize."""
        mine = [_Request(i, q) for i, q in keys[serve_rows(self._mesh, len(keys), bucket)]]
        err = None
        try:
            ds = self._featurize(mine or [self._dummy_request()], encode=False)
            if len(ds) != max(len(mine), 1):
                raise RuntimeError(f"featurization dropped rows: {len(ds)} != {len(mine)}")
        except Exception as e:
            err, mine = repr(e), []
            ds = self._featurize([self._dummy_request()], encode=False)
        decode = self._infer_async(ds, bucket)

        def resolve():
            if self._enc_cache is not None:
                self._enc_cache.apply(ds, [r.image_id for r in mine or [self._dummy_request()]])
            out = decode()
            answers, scores = out if self.confidence else (out, [])
            parts = self._link.gather(self._mesh, (answers[:len(mine)], scores[:len(mine)], err))
            errors = [e for _, _, e in parts if e]
            if errors:
                raise _BatchError(f"a rank's rows did not featurize: {errors[0]}")
            answers = [a for part in parts for a in part[0]]
            return (answers, [x for part in parts for x in part[1]]) if self.confidence \
                else answers

        return resolve

    def follow(self) -> None:
        """The loop of a rank other than 0 in a serving mesh: no queue, no
        threads; it takes rank 0's messages in order and steps the same
        decode on its rows of each batch, switching adapters and weights at
        the batch boundaries rank 0 switches at, until rank 0's stop. A
        failed collective raises: the mesh is broken."""
        if self._leader:
            raise RuntimeError("follow() runs on the ranks of a mesh other than 0")
        self._stream.enter()
        while True:
            message = self._link.recv()
            op = message["op"]
            if op == "stop":
                break
            if op == "reload":
                self._load_weights(message["loadtype"])
                with self._stats_lock:
                    self._reloads += 1
            elif op == "batch":
                self._activate(message["adapter"])
                resolve = self._mesh_batch(message["keys"], message["bucket"])
                t0 = time.perf_counter()
                try:
                    with self._watchdog.guard("decode"):
                        resolve()
                except _BatchError:
                    pass  # rank 0 fails the batch's requests
                self._decode_s += time.perf_counter() - t0
                with self._stats_lock:
                    self._batches += 1
                    self._bucket_batches[message["bucket"]] = \
                        self._bucket_batches.get(message["bucket"], 0) + 1
        self._close_graphs()
        self._watchdog.close()

    def _run(self):
        self._stream.enter()
        profiling.tile_thread()
        try:
            self._run_inner()
        except Exception as e:  # fatal dispatcher error (lost device, dead follower, ...)
            self._fail_inflight(e)
            self._inflight.put(None)  # release the resolver
        if self._link is not None and self._unhealthy is None:
            try:  # after every batch's message: the followers finish those first
                self._link.send({"op": "stop"})
            except Exception as e:
                self._fail_inflight(e)

    def _run_inner(self):
        """Dispatcher: gather -> featurize -> dispatch -> hand off. The
        resolver replays the decode and reads the rows, so this loop is back
        to assembling the next batch while the device decodes this one."""
        while True:
            with profiling.span("engine.collect") as sp:
                reqs = self._collect()
                batch = next(self._batch_ids)
                if sp:
                    sp.set(rows=len(reqs), batch=batch)
            if not reqs or self._unhealthy is not None:
                self._inflight.put(None)  # drain signal for the resolver
                return
            # claim the futures: a future cancelled while queued is dropped
            # here, and a RUNNING future can no longer be cancelled
            reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
            now = time.monotonic()
            with self._inflight_lock:  # visible to the stall handler
                self._inflight_reqs.update(reqs)
                self._claimed += len(reqs)
                self._queue_wait_s += sum(now - r.t_submit for r in reqs)
            if profiling.recording():
                wall = time.time_ns() - round((time.monotonic() - now) * 1e9)
                for r in reqs:
                    profiling.record("engine.queue", wall - round((now - r.t_submit) * 1e9),
                                     wall, batch=batch)
            # shed requests that cannot be served in time BEFORE featurizing:
            # one whose remaining deadline is under the measured service time
            # (EWMA of claim -> resolve) would only expire mid-decode after
            # taking a batch seat. (The gate copies the JAX engine's,
            # lock-out included: ROADMAP C.)
            min_left = self._service_ewma
            viable = lambda r: not r.deadline or r.deadline - now >= min_left  # noqa: E731
            expired = [r for r in reqs if not viable(r)]
            reqs = [r for r in reqs if viable(r)]
            for r in expired:  # record BEFORE resolving: a client observing
                self._record(r, "expired")  # the resolution sees a complete log
                fail_future(r.future, TimeoutError(
                    "deadline exceeded while queued" if r.deadline < now
                    else f"deadline cannot be met: {r.deadline - now:.2f}s left < "
                         f"{min_left:.2f}s estimated service time"))
            for r in reqs:
                r.t_slotted = now
            if expired:
                with self._inflight_lock:
                    self._inflight_reqs.difference_update(expired)
                with self._stats_lock:
                    self._expired += len(expired)
            if not reqs:
                continue
            # adapters: one decode per adapter group (FIFO within a group),
            # each handed off on its own, since a switch rewrites the weights
            # the in-flight graphs read
            groups = [reqs]
            if self._adapters:
                by_adapter: dict = {}
                for r in reqs:
                    by_adapter.setdefault(r.adapter, []).append(r)
                groups = list(by_adapter.values())
            with profiling.tag(batch=batch):
                for group in groups:
                    self._dispatch_group(group, batch)

    def _dispatch_group(self, reqs: List[_Request], batch: int) -> None:
        """Featurize and dispatch one batch of requests that share an
        adapter, then hand it to the resolver with the batch's id."""
        work = []
        while True:
            try:
                self._activate(reqs[0].adapter)
            except Exception as e:  # the resolver reports it per request
                work.append((reqs, None, None, e))
            with self._weights_cv:  # hold new batches while a reload waits
                while self._reload_waiting:
                    self._weights_cv.wait()
                # a reload that landed since the switch put the base back
                if work or self._active_adapter == reqs[0].adapter or not self._adapters:
                    self._batches_in_flight += 1
                    break
        if not work and self._link is None:
            try:
                with profiling.span("engine.featurize", rows=len(reqs)):
                    gen = self._enc_cache.generation if self._enc_cache is not None else None
                    ds = self._featurize(reqs)
                    # a reload between featurize and dispatch flushed the table:
                    # featurize again under the new weights
                    while self._enc_cache is not None and self._enc_cache.generation != gen:
                        gen = self._enc_cache.generation
                        ds = self._featurize(reqs)
                if len(ds) != len(reqs):
                    raise RuntimeError(f"featurization dropped rows: {len(ds)} != {len(reqs)}")
                # the smallest bucket that fits: a lone request rides the
                # small decode instead of padding to the full shape
                bucket = next(b for b in self.buckets if b >= len(reqs))
                with self._watchdog.guard("decode dispatch"), \
                        profiling.span("engine.encode", bucket=bucket):
                    resolve = self._infer_async(ds, bucket)
                work.append((reqs, bucket, resolve, None))
            except Exception as e:  # the resolver reports it per request
                work.append((reqs, None, None, e))
        elif not work:  # over a mesh: every rank steps the batch, failed or not
            bucket = next(b for b in self.buckets if b >= len(reqs))
            keys = [(r.image_id, r.question) for r in reqs]
            with self._watchdog.guard("mesh send"):
                self._link.send({"op": "batch", "keys": keys, "adapter": reqs[0].adapter,
                                 "bucket": bucket})
            work = [(reqs, bucket, self._mesh_batch(keys, bucket), None)]
        # bounded handoff (depth 2): blocks when the resolver is behind
        with profiling.span("engine.handoff"):
            self._inflight.put((reqs, work, batch))

    def _resolve_loop(self):
        self._stream.enter()
        profiling.tile_thread()
        try:
            self._resolve_loop_inner()
        except Exception as e:  # fatal resolver error
            self._fail_inflight(e)

    def _resolve_loop_inner(self):
        """Resolver: decode and read back the dispatched batches, then
        complete their futures."""
        while True:
            with profiling.span("engine.await_batch") as sp:
                item = self._inflight.get()
                if sp and item is not None:
                    sp.set(batch=item[2])
            if item is None:
                return
            reqs, work, batch = item
            try:
                with profiling.tag(batch=batch):
                    if not self._resolve_item(reqs, work):
                        return
            finally:
                with self._weights_cv:
                    self._batches_in_flight -= 1
                    self._weights_cv.notify_all()

    def _resolve_item(self, reqs, work) -> bool:
        """Resolve one handed-off batch; False when the engine turned
        unhealthy meanwhile (its futures are already failed). The decode's
        spans come from ``resolve`` (graph replay, read-back, detokenize);
        ``engine.complete`` covers the rest."""
        answers_by_req: dict = {}
        bucket_by_req: dict = {}
        n_ok_groups = 0
        buckets_used: list = []
        for group, bucket, resolve, exc in work:
            answers = None
            if exc is None:
                try:
                    t0 = time.perf_counter()
                    with self._watchdog.guard("decode materialize"):
                        answers = resolve()
                    self._decode_s += time.perf_counter() - t0
                    if self.confidence:
                        answers = [{"answer": a, "confidence": round(math.exp(s), 4)}
                                   for a, s in zip(*answers)]
                except _BatchError as e:
                    exc = e
                except Exception as e:
                    if self._mesh is not None:  # a collective failed: the mesh is broken
                        self._fail_inflight(e)
                        return False
                    exc = e
            with profiling.span("engine.complete"):
                if self._unhealthy is not None:
                    return False  # the stall fired mid-wait; futures already failed
                if exc is not None:  # resolve this group with the error
                    log.warning(f"serving batch of {len(group)} failed: {exc!r}")
                    for r in group:
                        self._record(r, "error", error=repr(exc))
                        fail_future(r.future, exc)
                    with self._inflight_lock:
                        self._inflight_reqs.difference_update(group)
                    with self._stats_lock:
                        self._failed += len(group)
                        self._batches += 1
                    continue
                n_ok_groups += 1
                buckets_used.append(bucket)
                for r, a in zip(group, answers):
                    answers_by_req[r] = a
                    bucket_by_req[r] = bucket
        with profiling.span("engine.complete"):
            return self._complete(reqs, answers_by_req, bucket_by_req, n_ok_groups,
                                  buckets_used)

    def _complete(self, reqs, answers_by_req: dict, bucket_by_req: dict, n_ok_groups: int,
                  buckets_used: list) -> bool:
        """Resolve the futures of a batch's decoded requests and count them."""
        reqs = [r for r in reqs if r in answers_by_req]
        if not reqs:
            return True
        now = time.monotonic()
        # a deadline that passed while the batch decoded resolves
        # TimeoutError: the client stopped waiting
        late = [r for r in reqs if r.deadline and r.deadline < now]
        for r in late:
            self._record(r, "expired", in_flight=True)
            fail_future(r.future, TimeoutError("deadline exceeded mid-decode"))
        reqs = [r for r in reqs if not (r.deadline and r.deadline < now)]
        for r in reqs:
            a = answers_by_req[r]
            text = a["answer"] if isinstance(a, dict) else a
            self._record(r, "ok", bucket=bucket_by_req[r], answer_chars=len(text))
            try:
                r.future.set_result(a)
            except Exception:  # lost a race with the stall handler
                pass
        with self._inflight_lock:
            self._inflight_reqs.difference_update(reqs)
            self._inflight_reqs.difference_update(late)
        for r in reqs:
            if r.t_slotted is not None:
                dt = now - r.t_slotted
                self._service_ewma = (dt if not self._service_ewma
                                      else 0.25 * dt + 0.75 * self._service_ewma)
        with self._stats_lock:
            self._served += len(reqs)
            self._expired += len(late)
            self._batches += n_ok_groups
            for b in buckets_used:
                self._bucket_batches[b] = self._bucket_batches.get(b, 0) + 1
            self._latencies_ms.extend((now - r.t_submit) * 1e3 for r in reqs)
            del self._latencies_ms[:-10000]
            if self._cache_size:
                # late answers are still valid model outputs: cache them
                for r in reqs + late:
                    self._cache[(r.image_id, r.question, r.adapter)] = answers_by_req[r]
                while len(self._cache) > self._cache_size:
                    self._cache.pop(next(iter(self._cache)))
        return True


#: name -> help of the counters ``/metrics`` exports for the gathered engine
GATHERED_COUNTERS = {
    "served": "requests answered",
    "failed": "requests resolved with an error",
    "batches": "decode batches dispatched",
    "cache_hits": "requests answered from the LRU cache",
    "reloads": "hot weight reloads",
    "expired": "requests shed after their deadline passed in queue",
    "adapter_switches": "LoRA adapter merges onto the base weights",
}


def prometheus_text(s: dict, counters: dict) -> str:
    """A stats dict in the Prometheus text exposition format: ``counters``
    (name -> help), the bucket counts, the queue depth and the latency
    summary."""
    lines = []
    for name, help_text in counters.items():
        lines += [
            f"# HELP phonovqa_{name}_total {help_text}",
            f"# TYPE phonovqa_{name}_total counter",
            f"phonovqa_{name}_total {s[name]}",
        ]
    if s.get("bucket_batches"):
        lines += [
            "# HELP phonovqa_bucket_batches_total decoded batches per compiled batch shape",
            "# TYPE phonovqa_bucket_batches_total counter",
        ]
        lines += [f'phonovqa_bucket_batches_total{{size="{k}"}} {v}'
                  for k, v in s["bucket_batches"].items()]
    lines += [
        "# HELP phonovqa_queue_depth requests waiting for a batch slot",
        "# TYPE phonovqa_queue_depth gauge",
        f"phonovqa_queue_depth {s['queue_depth']}",
        "# HELP phonovqa_request_latency_ms submit-to-resolution latency",
        "# TYPE phonovqa_request_latency_ms summary",
    ]
    for q, key in (("0.5", "p50_ms"), ("0.95", "p95_ms")):
        if s[key] is not None:
            lines.append(f'phonovqa_request_latency_ms{{quantile="{q}"}} {s[key]:.3f}')
    return "\n".join(lines) + "\n"
