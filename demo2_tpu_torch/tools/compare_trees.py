"""Time the port's kernels in several checkouts on one card, in turns.

    python3 -m demo2_tpu_torch.tools.compare_trees parent/ . . parent/
    python3 -m demo2_tpu_torch.tools.compare_trees --cases wide parent/ . . parent/
    python3 -m demo2_tpu_torch.tools.compare_trees --steps parent/ . . parent/
    python3 -m demo2_tpu_torch.tools.compare_trees --steps 442 parent/ . . parent/
    python3 -m demo2_tpu_torch.tools.compare_trees --yardstick parent/ .

Each argument is the root of a checkout (one that holds chip_smoke.py and
demo2_tpu_torch/).  One process per argument, in the order given, each in its
own checkout, so each builds and loads its own kernels: two commits are read
on the same card within one call, as parent, change, change, parent.  The
cases are the same in every process: this checkout's
chip_smoke.py::compare_cases and ::longer_compare_cases, which call only the
kernels' public wrappers, run against the package of the checkout under
test.  Every process prints
one line: for the block kernels 1, 2, 2's training form and 3 at x (192, 129,
768), the attention kernels 5, 6, 9 and 10 at qkv (192, 129, 2304) and
(192, 129, 12, 64), the re-ranking min-sum 12 on the weights of 1,600
queries among 4,800 clustered features and the saved-probs backwards 8, 4
and 7 at qkv (192, 129, 2304), and the wide pair of 5 and 6 at S = 211, 129
and 256 with heads of 64 and 96, and kernels 1, 3, 4 and 7 past the
register tiles at x (192, 211, 768) ("block 211": their wide forms), (192,
442, 768) and (64, 311, 768) ("block 442", "block 311": their long forms),
the median [min .. max] in ms of six rounds of 20 launches by CUDA events,
taken kernel by kernel in turns, and a digest of each case's output bits
(chip_smoke.py::digest: equal digests, equal bits), with the card's name and
power limit; a case the checkout refuses (NotImplementedError: a shape its
kernels do not take) is named as refused.  `--cases TEXT` keeps the cases
whose name holds TEXT (`wide`: the wide pair alone; `block 211`: the block
kernels' wide forms alone).  `--steps` times instead the
stride-12 flagship's train step and batch-64 request (chip_smoke.py::
time_long_step: host wall, six rounds, and the profiler's device busy with
its largest items), at 211 tokens (256x128) or at the crop of the tokens
given after it (442: 256x256; chip_smoke.py::STEP_CROPS).
`--yardstick` prints scaled_dot_product_attention's forward and backward at
the long forms' shape and the profiler's rows of kernels 1, 3, 4 and 7
there (chip_smoke.py::long_yardstick), so that their attention launch
stands beside a well-made attention.  Two readings of one checkout say how
far two processes differ before two checkouts are compared.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

ROUNDS = 6
STEPS = "--steps"  # the stride-12 flagship's step and request in place of the kernel cases
YARDSTICK = "--yardstick"  # the long forms beside scaled_dot_product_attention
TREE_SECONDS = 900  # one checkout's build and turns; a hung process fails the comparison
CHIP_SMOKE = Path(__file__).resolve().parents[2] / "chip_smoke.py"  # the cases' source
CHILD = f"""
import importlib.util, os, sys
sys.path.insert(0, os.getcwd())  # the package of the checkout under test
import torch
spec = importlib.util.spec_from_file_location("chip_smoke", {str(CHIP_SMOKE)!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
if not torch.cuda.is_available():
    raise SystemExit("compare_trees needs a CUDA device")
device = torch.device("cuda", 0)
cs.exact_products()
keep = sys.argv[1]  # the --cases filter ("" keeps every case), --steps or --yardstick
if keep == {STEPS!r}:
    line = cs.time_long_step(device, cs.card_line(), tokens=int(sys.argv[2]))
    print(f"{{os.getcwd()}}: {{line}}", flush=True)
    raise SystemExit(0)
if keep == {YARDSTICK!r}:
    print(f"{{os.getcwd()}}: {{cs.long_yardstick(device, cs.card_line())}}", flush=True)
    raise SystemExit(0)
cases = {{**cs.compare_cases(device), **cs.longer_compare_cases(device)}}
cases = {{name: call for name, call in cases.items() if keep in name}}
bits, refused = {{}}, []
for name, call in list(cases.items()):
    try:
        bits[name] = cs.digest(call())
    except NotImplementedError:
        refused.append(name)
        del cases[name]
got = {{name: [] for name in cases}}
for _ in range({ROUNDS}):
    for name, call in cases.items():
        got[name].append(cs.cuda_ms(call, 20))
times = ", ".join(f"{{name}} {{cs.spread(ms)}} #{{bits[name]}}" for name, ms in got.items())
refused = f"; refused: {{', '.join(refused)}}" if refused else ""
print(f"{{os.getcwd()}}: {{times}} ms{{refused}} ({{cs.card_line()}})", flush=True)
"""


def parse(args: list[str]) -> tuple:
    """(the child's arguments, the trees) of a command line."""
    keep, trees = [""], args
    if args[:1] == ["--cases"] and len(args) > 1:
        keep, trees = args[1:2], args[2:]
    elif args[:1] == [STEPS]:
        tokens = args[1] if args[1:2] and args[1].isdigit() else "211"
        keep, trees = [STEPS, tokens], args[1 + (args[1:2] == [tokens]):]
    elif args[:1] == [YARDSTICK]:
        keep, trees = [YARDSTICK], args[1:]
    if not trees:
        raise SystemExit("usage: python3 -m demo2_tpu_torch.tools.compare_trees "
                         "[--cases TEXT | --steps [TOKENS] | --yardstick] TREE [TREE ...]")
    return keep, trees


def main(args: list[str]) -> None:
    keep, trees = parse(args)
    for tree in trees:
        if not (Path(tree) / "chip_smoke.py").is_file():
            raise SystemExit(f"compare_trees: {tree} holds no chip_smoke.py")
    for tree in trees:
        done = subprocess.run([sys.executable, "-c", CHILD, *keep], cwd=tree,
                              capture_output=True, text=True, timeout=TREE_SECONDS)
        if done.returncode != 0:
            raise SystemExit(f"compare_trees: {tree} failed:\n{done.stdout}{done.stderr}")
        lines = done.stdout.strip().splitlines()
        # --steps, --yardstick: the profiles' lines too, where the time goes
        shown = [x for x in lines if x.startswith("[profile]")] if keep[0] in (STEPS, YARDSTICK) \
            else []
        print("\n".join(shown + lines[-1:]), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
