"""Ablations of the wide pair of kernels 5 and 6, timed in turns on one card.

    python3 -m demo2_tpu_torch.tools.wide_ablate OUT_DIR

writes one checkout per ablation under OUT_DIR (this checkout's chip_smoke.py
and demo2_tpu_torch/, with csrc/packed_attention_wide.cu changed by the text
substitutions below), then times the wide pair at S = 211 with 12 heads of 64
and with 8 of 96 in this checkout, in every ablation and in this checkout
again, in turns, through tools/compare_trees.py (one process each).  An
ablation leaves work out, or serves every copy from L2; its outputs are wrong
and only its times are read:

  copies     the loads and stores alone: each task acquires and releases its
             item's operands and stores, computing nothing;
  l2         every item of a block reads the tiles of the block's first item,
             which L2 then serves: the kernels with device memory out of the
             way;
  fwd_nomax  the forward without its first pass (m = 0);
  fwd_noexp  the forward with e = s * scale - m in place of expf;
  fwd_nopv   the forward without the PV product;
  bwd_noko   the backward's key-owner tasks compute nothing (dK, dV zero);
  bwd_nodq   the backward's query-owner tasks skip the dQ pass;
  bwd_exp2   the backward with ex2.approx in place of both expf.

    python3 -m demo2_tpu_torch.tools.wide_ablate --block OUT_DIR

does the same for the block kernels' wide forms (csrc/attention_wide_block.cuh,
BLOCK_ABLATIONS below), timing kernels 1, 3, 4 and 7 at x (192, 211, 768)
(compare_cases' "block 211" cases):

  bwd_pconst   kernels 4 and 7 without the copies of P (the strip slots are
               read as they lie);
  bwd_noko     the backward's key warps compute nothing (dK, dV zero);
  bwd_nodq     the backward's query warps skip the dQ product;
  fwd_noexp    the forward with e = s * scale - m in place of expf;
  fwd_nopv     the forward without the PV product;
  fwd_nostore  kernel 3 without its probs (no staging, no store).

    python3 -m demo2_tpu_torch.tools.wide_ablate --long OUT_DIR

does the same for the block kernels' long forms (csrc/attention_long_block.cuh,
LONG_ABLATIONS below), timing kernels 1, 3, 4 and 7 at x (192, 442, 768)
(the "block 442" cases of chip_smoke.py::longer_compare_cases):

  bwd_pconst   kernels 4 and 7 without the copies of P (Q's and dO's rows
               alone come into the strip slots);
  bwd_noko     the backward's key warps compute nothing (dK, dV zero);
  bwd_nodq     the backward's query warps skip the dQ product (the halves of
               dQ's partial are still traded);
  fwd_noexp    the forward with e = s * scale - m in place of expf;
  fwd_nopv     the forward without the PV products;
  fwd_nostore  kernel 3 without the copy of its p to probs.

OUT_DIR should be a directory that .gitignore lists; it is emptied first.
"""

from __future__ import annotations

import shutil
import sys
from pathlib import Path

from . import compare_trees

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "demo2_tpu_torch" / "csrc" / "packed_attention_wide.cu"
CASES = "211x"  # the wide pair's cases of compare_cases at S = 211
BLOCK_SOURCE = ROOT / "demo2_tpu_torch" / "csrc" / "attention_wide_block.cuh"
BLOCK_CASES = "block 211"  # kernels 1, 3, 4 and 7's cases of compare_cases at S = 211
LONG_SOURCE = ROOT / "demo2_tpu_torch" / "csrc" / "attention_long_block.cuh"
LONG_CASES = "block 442"  # their long forms' cases of longer_compare_cases at S = 442

_FWD_BODY = ("    uint32_t qa[D / 16][4];\n", "    const float d0 = quad_sum(sum0)")
_BWD_BODY = ("    if (!key_owner) {  // query rows r0 .. r0 + 15\n", "\n  }\n}\n\n// ---- launches")

_FWD_COPIES = """    float o[D / 8][4];
    wide_zero<D>(o);
    float sum0 = 0.f, sum1 = 0.f;
    for (int op = 0; op < 3; ++op) {
      o[0][0] += __bfloat162float(ring.acquire(3 * i + op)[lane]);
      ring.release(3 * i + op, lane, load);
    }
"""
_BWD_COPIES = """    float acc[D / 8][4];
    wide_zero<D>(acc);
    for (int op = 0; op < 4; ++op) {
      acc[0][0] += __bfloat162float(ring.acquire(op0 + op)[lane]);
      ring.release(op0 + op, lane, load);
    }
    wide_store<D>(acc, scale, dhead + (key_owner ? C : 0), row3, r0, S, lane);
    if (key_owner) wide_store<D>(acc, 1.f, dhead + 2 * C, row3, r0, S, lane);"""

# name: [(old, new), ...]; a (start, end) pair as `old` replaces the text from
# start up to (not including) end.
ABLATIONS = {
    "copies": [(_FWD_BODY, _FWD_COPIES), (_BWD_BODY, _BWD_COPIES)],
    "l2": [("const int item = blockIdx.x + (n / 3) * gridDim.x;", "const int item = blockIdx.x;"),
           ("const int item = blockIdx.x + (n / 4) * gridDim.x;", "const int item = blockIdx.x;")],
    "fwd_nomax": [
        ("    float m0 = -INFINITY, m1 = -INFINITY;\n    for (int n0 = 0; n0 < s_pad; n0 += 16) {",
         "    float m0 = -INFINITY, m1 = -INFINITY;\n    for (int n0 = 0; n0 < 0; n0 += 16) {"),
        ("    m0 = quad_max(m0);\n    m1 = quad_max(m1);\n\n    // The second",
         "    m0 = 0.f;\n    m1 = 0.f;\n\n    // The second")],
    "fwd_noexp": [("? expf(__fmul_rn(s[j][e], scale) - (e < 2 ? m0 : m1))",
                   "? __fmul_rn(s[j][e], scale) - (e < 2 ? m0 : m1)")],
    "fwd_nopv": [("      wide_accumulate<D>(o, pa, v_s, s_pad, n0, lane);",
                  "      o[0][0] += __uint_as_float(pa[0] ^ pa[1] ^ pa[2] ^ pa[3]);")],
    "bwd_noko": [("      for (int i0 = 0; i0 < s_pad; i0 += 16) {",
                  "      for (int i0 = 0; i0 < 0; i0 += 16) {")],
    "bwd_nodq": [("        if (j < pairs) {\n          float ds[2][4];",
                  "        if (j < 0) {\n          float ds[2][4];")],
    "bwd_exp2": [("expf(__fmul_rn(st[j][e], scale) - (lo ? m.x : m.y))",
                  "exp2_approx((st[j][e] * scale - (lo ? m.x : m.y)) * kLog2e)"),
                 ("expf(p[nt][e] - (e < 2 ? m0 : m1))",
                  "exp2_approx((p[nt][e] - (e < 2 ? m0 : m1)) * kLog2e)")],
}

BLOCK_ABLATIONS = {
    "bwd_pconst": [
        ("    mbar_arrive_expect(bar, static_cast<uint32_t>((s_pad + 63) / 64 * kProbsBoxElems"
         " * 2));\n"
         "    for (int c = 0; c < s_pad; c += 64)\n"
         "      tma_load_probs(dst + (c >> 6) * kProbsBoxElems, &probs_map, c, r0, item, bar);",
         "    mbar_arrive(bar);")],
    "bwd_noko": [("          if (k0 < s_pad) {\n            const int c = (k0 >> 3)",
                  "          if (k0 < 0) {\n            const int c = (k0 >> 3)")],
    "bwd_nodq": [("          if (j < pairs) {\n            uint32_t dsa[4];\n"
                  "            ldmatrix_x4(",
                  "          if (j < 0) {\n            uint32_t dsa[4];\n"
                  "            ldmatrix_x4(")],
    "fwd_noexp": [("const float x = expf(s[nt][e] - (e < 2 ? m0 : m1));",
                   "const float x = s[nt][e] - (e < 2 ? m0 : m1);")],
    "fwd_nopv": [("      if (j < cnt) block_accumulate(o, pa[j], v_s, 16 * (j0 + j), lane);",
                  "      if (j < cnt)\n"
                  "        o[0][0] += __uint_as_float(pa[j][0] ^ pa[j][1] ^ pa[j][2]"
                  " ^ pa[j][3]);")],
    "fwd_nostore": [("    if constexpr (kSaveProbs) {\n"
                     "      // This half's p through the warp's staging tile",
                     "    if constexpr (false) {\n"
                     "      // This half's p through the warp's staging tile")],
}


LONG_ABLATIONS = {
    "bwd_pconst": [
        ("    mbar_arrive_expect(bar, static_cast<uint32_t>((boxes * kProbsBoxElems + 2 * "
         "kLongRowTileElems) *\n"
         "                                                  sizeof(bf16)));\n"
         "    for (int c = 0; c < boxes; ++c)\n"
         "      tma_load_probs(dst + c * kProbsBoxElems, &probs_map, 16 * kj0 + 64 * c, r0, item, "
         "bar);",
         "    mbar_arrive_expect(bar, static_cast<uint32_t>(2 * kLongRowTileElems * "
         "sizeof(bf16)));")],
    "bwd_noko": [("          if (lk < kcnt) {\n            const int c = 2 * lk",
                  "          if (lk < 0) {\n            const int c = 2 * lk")],
    "bwd_nodq": [("        for (int j = 0; j < kcnt; ++j) {\n          uint32_t dsa[4];",
                  "        for (int j = 0; j < 0; ++j) {\n          uint32_t dsa[4];")],
    "fwd_noexp": [("const float x = expf(s[c][e] - ((e & 2) ? m1 : m0));",
                   "const float x = s[c][e] - ((e & 2) ? m1 : m0);")],
    "fwd_nopv": [("      for (int hh = 0; hh < 2; ++hh)\n        LongMma<64>::rs<1>(o,",
                  "      for (int hh = 0; hh < 0; ++hh)\n        LongMma<64>::rs<1>(o,")],
    "fwd_nostore": [("    if constexpr (kSaveProbs) {\n      // The warp's 16 rows of p to probs",
                     "    if constexpr (false) {\n      // The warp's 16 rows of p to probs")],
}


def ablated(source: str, name: str, ablations: dict | None = None) -> str:
    """The kernel source with ablation `name` of `ablations` (ABLATIONS by
    default) applied; raises if a piece of text it changes is not found
    exactly once."""
    for old, new in (ablations or ABLATIONS)[name]:
        if isinstance(old, tuple):
            start, end = old
            if source.count(start) != 1:
                raise ValueError(f"ablation {name}: {start!r} is not found exactly once")
            a = source.index(start)
            b = source.index(end, a)
            source = source[:a] + new + source[b:]
        else:
            if source.count(old) != 1:
                raise ValueError(f"ablation {name}: {old!r} is not found exactly once")
            source = source.replace(old, new)
    return source


def write_trees(out_dir: Path, source_path: Path = SOURCE,
                ablations: dict | None = None) -> list[Path]:
    """One checkout per ablation of `ablations` (of `source_path`) under
    out_dir, emptied first."""
    ablations = ablations or ABLATIONS
    source = source_path.read_text()
    shutil.rmtree(out_dir, ignore_errors=True)
    trees = []
    for name in ablations:
        tree = out_dir / name
        shutil.copytree(ROOT / "demo2_tpu_torch", tree / "demo2_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        shutil.copy(ROOT / "chip_smoke.py", tree / "chip_smoke.py")
        (tree / "demo2_tpu_torch" / "csrc" / source_path.name).write_text(
            ablated(source, name, ablations))
        trees.append(tree)
    return trees


# The runs: the option, its source, its ablations and its cases.
RUNS = {None: (SOURCE, ABLATIONS, CASES),
        "--block": (BLOCK_SOURCE, BLOCK_ABLATIONS, BLOCK_CASES),
        "--long": (LONG_SOURCE, LONG_ABLATIONS, LONG_CASES)}


def main(args: list[str]) -> None:
    option = args[0] if args[:1] in (["--block"], ["--long"]) else None
    args = args[1:] if option else args
    if len(args) != 1:
        raise SystemExit("usage: python3 -m demo2_tpu_torch.tools.wide_ablate "
                         "[--block | --long] OUT_DIR")
    source, ablations, cases = RUNS[option]
    trees = write_trees(Path(args[0]).resolve(), source, ablations)
    compare_trees.main(["--cases", cases, str(ROOT), *map(str, trees), str(ROOT)])


if __name__ == "__main__":
    main(sys.argv[1:])
