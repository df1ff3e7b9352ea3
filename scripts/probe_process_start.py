"""Where ``chip_smoke.py``'s subprocess phases (17: the serve CLI, 19: the
reference converter and ``run --mode eval``) spend their time, on the card
(the port, ``phoneme_vqa_torch``).

    python scripts/probe_process_start.py OUT_DIR [--shared-bytecode]

Runs phases 17 and 19 as ``chip_smoke.py`` does, each subprocess's stderr
(its log lines carry timestamps) written to ``OUT_DIR/run<i>.err`` with its
argv, start and seconds; then one ``python -m cProfile`` of ``serve
--prime`` at full width (``prime.prof``, its top 60 by cumulative time in
``prime.txt``) and ``python -X importtime -c "import
phoneme_vqa_torch.serve"`` (``importtime.err``). Prints one line a
subprocess and a phase.
Run it as ``chip_smoke.py`` runs, or with its ``share_bytecode()`` first
(``--shared-bytecode``) to see what a shared bytecode cache leaves.
"""

import os
import pstats
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    if len(args) != 1:
        sys.exit(__doc__)
    out = os.path.abspath(args[0])
    os.makedirs(out, exist_ok=True)
    if "--shared-bytecode" in sys.argv:
        cs.share_bytecode()
    real_run, n = subprocess.run, [0]

    def run(argv, **kw):
        n[0] += 1
        t0 = time.time()
        r = real_run(argv, **kw)
        took = time.time() - t0
        with open(os.path.join(out, f"run{n[0]}.err"), "w", encoding="utf-8") as f:
            f.write(f"# {argv}\n# started {t0:.3f} took {took:.1f} s rc {r.returncode}\n")
            f.write(r.stderr or "")
        print(f"run{n[0]}: {' '.join(argv[1:4])} took {took:.1f} s", flush=True)
        return r

    cs.subprocess.run = run
    cs._build.build(*cs.KERNELS)
    root = tempfile.mkdtemp()
    for name, phase in (("phase 17", lambda: cs.cli_phase(cs.train_fixture(root), root)),
                        ("phase 19", lambda: cs.converter_phase(cs.sal_train_fixture(root),
                                                                root))):
        t0 = time.time()
        phase()
        print(f"{name} {time.time() - t0:.1f} s", flush=True)
    prof = os.path.join(out, "prime.prof")
    t0 = time.time()
    r = real_run([sys.executable, "-m", "cProfile", "-o", prof, "-m", "phoneme_vqa_torch.serve",
                  "--config-file", os.path.join(root, "latr_base_serve.json"), "--ckpt", "none",
                  "--max-length", str(cs.MAX_ANSWER), "--prime", "--buckets", "1,4"],
                 cwd=cs.REPO, capture_output=True, text=True)
    print(f"profiled prime {time.time() - t0:.1f} s rc {r.returncode}", flush=True)
    with open(os.path.join(out, "prime.txt"), "w", encoding="utf-8") as f:
        pstats.Stats(prof, stream=f).sort_stats("cumulative").print_stats(60)
    t0 = time.time()
    r = real_run([sys.executable, "-X", "importtime", "-c", "import phoneme_vqa_torch.serve"],
                 cwd=cs.REPO, capture_output=True, text=True)
    with open(os.path.join(out, "importtime.err"), "w", encoding="utf-8") as f:
        f.write(r.stderr)
    print(f"import phoneme_vqa_torch.serve {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
