"""CUDA graphs of the decode: the port's counterpart of the compiled serve
executable (``phoneme_vqa_tpu/serving/aot.py``'s ``AotGenerateDispatch``:
"no compile on the request path; one program per bucket").

A LaTr-base generate launches ~890 small kernels per decode step from
Python, and the card waits on that host loop. Here the decode of one batch
size is captured once, at warmup, into CUDA graphs over static buffers (the
stacked self-attention cache, the cross-attention K/V, the relative bias,
the encoder mask, the output rows, the done flags and the scores), and a
batch replays them:

* the encode stays eager, so the attention kernels keep their launch
  counters (``ops/flash_attention.py``, ``ops/sal_fused_attention.py``);
  its cache, bias and mask are copied into the static buffers;
* the decode is captured in chunks of ``STEPS_PER_GRAPH`` steps, each
  step the very operations of ``decode/greedy.py``'s loop at a fixed
  position (a step's position is a Python int there), so the rows are
  bit for bit ``executor.infer``'s. The loop's all-done exit is read
  between chunks; a row that is done emits pad and keeps its score, so the
  steps of a chunk past the exit change nothing that is read;
* a capture that fails raises: on a CUDA device the decode never falls
  back to the eager loop. On the CPU nothing is captured and the same
  operations run eagerly (the caller asked for the CPU); so they do on the
  card where the caller passes ``captured=False`` (over gloo, below).

Graphs cannot be serialized, so every process captures its own at warmup
(``serving/aot.py`` keeps the built kernels only). Over a mesh each rank
captures its share of each bucket; the model axis's NCCL collectives are
captured inside, and over gloo at model > 1 the chunks run uncaptured
(``serving/engine.py: captured_decode``). Every model rank of a data rank
reads the same gathered logits, so it leaves the loop after the same chunk
(``chunks_run`` counts them). The graphs read the
parameters at their addresses: a reload must copy into the parameters'
storage (``BaseExecutor.load_params`` does), never rebind them;
:func:`param_addresses` lets an engine check that.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..decode.greedy import greedy_step, multi_head_greedy_step
from ..models.generate import decode_token_ids

#: decode steps per captured graph: the all-done exit is read after each
STEPS_PER_GRAPH = 4


def capture(fn: Callable[[], None], pool=None) -> torch.cuda.CUDAGraph:
    """A CUDA graph of ``fn()``, captured on the current stream (which must
    not be the default stream) after one eager warm-up run there. ``fn``
    reads and writes only tensors that exist before the call; whatever it
    allocates lives in the graph's ``pool``. Raises when the capture
    fails."""
    stream = torch.cuda.current_stream()
    if stream == torch.cuda.default_stream(stream.device):
        raise RuntimeError("graphs are captured on a side stream, not the default stream")
    fn()  # warm-up: cuBLAS workspaces and the allocator's blocks, outside the graph
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
        fn()
    return graph


def param_addresses(model: torch.nn.Module) -> Dict[str, int]:
    return {name: p.data_ptr() for name, p in model.named_parameters()}


def check_params_in_place(model: torch.nn.Module, addresses: Dict[str, int]) -> None:
    """Raises when a parameter no longer lives where the graphs read it."""
    moved = [n for n, a in param_addresses(model).items() if addresses.get(n) != a]
    if moved:
        raise RuntimeError(f"parameters were rebound, not copied in place ({moved[:3]}): the "
                           "captured graphs would read the old weights")


class GraphDecoder:
    """The greedy decode of one batch size (a bucket) of ``model`` over
    static buffers, as ``models.generate.build_generate_fn``'s greedy
    generate at ``max_length`` (token rows, or the triple decoder's
    (onset, rhyme, tone) rows stopped by the onset).

    ``start(batch)`` launches the encode of a device batch of this size
    and returns ``finish()``, which loads the static buffers, replays the
    decode and returns what the generate returns: the rows, and with
    ``with_scores`` the mean emitted-token log-probabilities. ``finish``
    calls run one at a time (the engine's resolver thread). ``example``:
    a device batch of this size, whose encode sizes the buffers. On a CUDA
    device the caller sets the stream that captures and replays;
    ``captured=False`` runs the chunks there uncaptured (their collectives
    go through the host)."""

    def __init__(self, model, example: dict, max_length: int, with_scores: bool = False,
                 pool=None, captured: bool = True):
        self.model = model.eval()  # the decode captured without dropout, as generate runs it
        self.max_length = int(max_length)
        self.with_scores = bool(with_scores)
        self.components = int(getattr(model, "decode_components", 1))
        self.bos, self.eos, self.pad = decode_token_ids(model)
        self.chunks = [range(s, min(s + STEPS_PER_GRAPH, self.max_length - 1))
                       for s in range(0, self.max_length - 1, STEPS_PER_GRAPH)]
        with torch.inference_mode():
            cache, full_bias, enc_mask = self._encode(example)
            self.cache = {n: torch.empty_like(t) for n, t in cache.items()}
            self.full_bias = None if full_bias is None else torch.empty_like(full_bias)
            self.enc_mask = torch.empty_like(enc_mask)
            b = enc_mask.shape[0]
            shape = (b, self.max_length) + ((self.components,) if self.components > 1 else ())
            self.out = torch.empty(shape, dtype=torch.long, device=enc_mask.device)
            self.done = torch.empty(b, dtype=torch.bool, device=enc_mask.device)
            self.sum_lp = torch.empty(b, dtype=torch.float32, device=enc_mask.device)
            self.count = torch.empty(b, dtype=torch.float32, device=enc_mask.device)
            self._load(cache, full_bias, enc_mask)
            self.graphs = None
            self.chunks_run = 0
            self.closed = False
            if captured and enc_mask.is_cuda:
                self.graphs = [capture(lambda c=c: self._steps(c), pool) for c in self.chunks]

    @property
    def batch_size(self) -> int:
        return self.done.shape[0]

    def _encode(self, batch):
        return self.model.encode_for_generate(batch, self.max_length)

    def _load(self, cache, full_bias, enc_mask) -> None:
        """The encode's outputs into the static buffers, and the loop state
        as the greedy loops start it."""
        for name, t in cache.items():
            self.cache[name].copy_(t)
        if full_bias is not None:
            self.full_bias.copy_(full_bias)
        self.enc_mask.copy_(enc_mask)
        self.out.fill_(self.pad)
        self.out[:, 0] = self.bos
        self.done.zero_()
        self.sum_lp.zero_()
        self.count.zero_()

    def _step(self, tokens, cache, i: int):
        return self.model.decode_step(tokens, cache, i, self.full_bias, self.enc_mask)

    def _steps(self, chunk) -> None:
        for i in chunk:
            if self.components == 1:
                greedy_step(self._step, self.cache, i, self.out, self.done, self.sum_lp,
                            self.count, self.eos, self.pad, self.with_scores)
            else:
                multi_head_greedy_step(self._step, self.cache, i, self.out, self.done,
                                       self.sum_lp, self.count, self.eos, self.pad, 0,
                                       self.with_scores)

    def close(self) -> None:
        """Drop the captured graphs; a later batch raises. NCCL does not
        tear a communicator down while a graph that holds its collectives
        lives (the process hangs at exit), so an engine closes its decoders
        when it stops, before its process group goes."""
        self.graphs, self.closed = None, True

    def start(self, batch: dict) -> Callable[[], object]:
        if self.closed:
            raise RuntimeError("the graph decoder was closed (its engine stopped)")
        rows = int(next(iter(batch.values())).shape[0])
        if rows != self.batch_size:
            raise ValueError(f"a batch of {rows} rows for the decoder of {self.batch_size}")
        with torch.inference_mode():
            encoded = self._encode(batch)
        return lambda: self._finish(*encoded)

    @torch.inference_mode()
    def _finish(self, cache, full_bias, enc_mask):
        self._load(cache, full_bias, enc_mask)
        for j, chunk in enumerate(self.chunks):
            if self.graphs is None:
                self._steps(chunk)
            else:
                self.graphs[j].replay()
            self.chunks_run += 1
            if bool(self.done.all()):
                break
        out = self.out.clone()
        if self.with_scores:
            return out, self.sum_lp / self.count.clamp(min=1.0)
        return out


def decoder_bytes(decoder: Optional[GraphDecoder]) -> int:
    """Bytes of a decoder's static buffers."""
    if decoder is None:
        return 0
    tensors = [*decoder.cache.values(), decoder.enc_mask, decoder.out, decoder.done,
               decoder.sum_lp, decoder.count]
    if decoder.full_bias is not None:
        tensors.append(decoder.full_bias)
    return sum(t.numel() * t.element_size() for t in tensors)
