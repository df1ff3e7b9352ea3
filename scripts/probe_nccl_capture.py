"""Whether a CUDA graph holding NCCL collectives captures and replays on
the cards in the way the serving engines use one (the port,
``phoneme_vqa_torch/serving/graphs.py``), stage by stage.

    python scripts/probe_nccl_capture.py [--out DIR] [--timeout S]

Needs two cards. For each variant of the process environment
(``TORCH_NCCL_ASYNC_ERROR_HANDLING`` unset, then ``0``) it spawns two NCCL
ranks on a ``DeviceMesh`` of data 1 x model 2, as the serving mesh is
built (``init_process_group`` without ``device_id``: every communicator is
made at its group's first collective). Each rank writes one ``PROBE`` line
a stage to ``DIR/probe_nccl_capture_<variant>_rank<r>.log`` as it reaches
it (line-buffered, so a hang leaves the last stage reached):

1. an eager all-reduce on the model group, on a side stream;
2. the capture of a graph on that stream (``capture_error_mode
   "thread_local"``, after one eager run, as ``graphs.capture``): a
   matmul, an all-reduce and an all-gather into a tensor on the model group;
3. 50 replays, the output against the eager run's;
4. 20 rounds of an eager all-reduce then a replay on the same group;
5. 20 replays from a second thread (the engine's resolver), while the
   first thread broadcasts on a gloo group (the engine's control link);
6. a second graph captured in the same pool after those replays (another
   bucket), then both replayed in turn;
7. both graphs dropped (``del``, then a synchronize), then
   ``destroy_process_group``, then the process's exit.

The parent prints one line a variant and rank: the last stage reached,
its seconds, and whether the run ended within ``--timeout``. A rank that
reaches ``done`` but not ``destroyed`` hangs in the group's teardown: with
the graphs still alive there it does (NVIDIA H100, torch 2.11, NCCL
2.28.9), which is why the engines close their graphs when they stop.
"""

import argparse
import os
import sys
import threading
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

VARIANTS = {"unset": None, "async0": "0"}


def _rank(rank: int, port: int, variant: str, out: str) -> None:
    value = VARIANTS[variant]
    os.environ.pop("TORCH_NCCL_ASYNC_ERROR_HANDLING", None)
    if value is not None:
        os.environ["TORCH_NCCL_ASYNC_ERROR_HANDLING"] = value
    log = open(os.path.join(out, f"probe_nccl_capture_{variant}_rank{rank}.log"), "w",
               buffering=1)
    t0 = time.perf_counter()

    def stage(name: str, **extra) -> None:
        print(f"PROBE {variant} rank {rank} {name} {time.perf_counter() - t0:.3f}s "
              + " ".join(f"{k}={v}" for k, v in extra.items()), file=log)

    try:
        torch.cuda.set_device(rank)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                                world_size=2, timeout=timedelta(seconds=60))
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "model"))
        tp = mesh.get_group("model")
        link = dist.new_group(backend="gloo", timeout=timedelta(seconds=60))
        stage("start", torch=torch.__version__, nccl=".".join(map(str, torch.cuda.nccl.version())),
              env=os.environ.get("TORCH_NCCL_ASYNC_ERROR_HANDLING"))
        stream = torch.cuda.Stream()
        g = torch.Generator(device="cuda").manual_seed(0)
        w = torch.randn(256, 256, device="cuda", generator=g)
        x = torch.randn(64, 256, device="cuda", generator=g)
        gathered = torch.empty(128, 256, device="cuda")

        def step(scale: float = 1.0):
            y = (x @ w) * scale
            dist.all_reduce(y, group=tp)
            dist.all_gather_into_tensor(gathered, y, group=tp)
            return gathered.sum()

        with torch.cuda.stream(stream):
            probe = torch.ones(1, device="cuda")
            dist.all_reduce(probe, group=tp)
            want = step().clone()
        torch.cuda.synchronize()
        stage("eager", all_reduce=float(probe))
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(stream):
            step()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                got = step()
        torch.cuda.synchronize()
        stage("capture")
        with torch.cuda.stream(stream):
            for _ in range(50):
                graph.replay()
        torch.cuda.synchronize()
        stage("replay", equal=bool(torch.equal(got, want)))
        with torch.cuda.stream(stream):
            for _ in range(20):
                probe.fill_(1.0)
                dist.all_reduce(probe, group=tp)
                graph.replay()
        torch.cuda.synchronize()
        stage("mixed", all_reduce=float(probe), equal=bool(torch.equal(got, want)))

        errors = []

        def resolver():
            try:
                torch.cuda.set_device(rank)
                torch.cuda.set_stream(stream)
                for _ in range(20):
                    graph.replay()
                    torch.cuda.current_stream().synchronize()
            except BaseException as e:  # reported by the stage line
                errors.append(repr(e))

        thread = threading.Thread(target=resolver)
        thread.start()
        for i in range(20):
            box = [i if rank == 0 else None]
            dist.broadcast_object_list(box, src=0, group=link)
        thread.join()
        stage("threads", errors=errors or None, equal=bool(torch.equal(got, want)))
        with torch.cuda.stream(stream):
            step(2.0)
            graph2 = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph2, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                got2 = step(2.0)
            for _ in range(10):
                graph.replay()
                graph2.replay()
        torch.cuda.synchronize()
        stage("second_graph", equal=bool(torch.equal(got2, 2 * want)))
        dist.barrier(group=link)
        stage("done")
        del graph, graph2, got, got2
        torch.cuda.synchronize()
        stage("released")
        dist.destroy_process_group()
        stage("destroyed")
    except BaseException:
        print(traceback.format_exc(), file=log)
        raise
    finally:
        log.close()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python scripts/probe_nccl_capture.py")
    parser.add_argument("--out", default=".")
    parser.add_argument("--timeout", type=float, default=60.0)
    args = parser.parse_args(argv)
    if torch.cuda.device_count() < 2:
        print("probe_nccl_capture: needs two cards", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    ctx = mp.get_context("spawn")
    failed = False
    for variant in VARIANTS:
        t0 = time.perf_counter()
        port = _free_port()
        procs = [ctx.Process(target=_rank, args=(r, port, variant, args.out)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(max(1.0, args.timeout - (time.perf_counter() - t0)))
        hung = [p.is_alive() for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        for r, p in enumerate(procs):
            path = os.path.join(args.out, f"probe_nccl_capture_{variant}_rank{r}.log")
            lines = open(path).read().splitlines() if os.path.exists(path) else []
            last = next((ln for ln in reversed(lines) if ln.startswith("PROBE")), "none")
            print(f"probe_nccl_capture {variant} rank {r}: exit {p.exitcode}, "
                  f"{'HUNG' if hung[r] else 'ended'} after {time.perf_counter() - t0:.1f} s; "
                  f"last: {last}", flush=True)
            failed |= hung[r] or p.exitcode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
