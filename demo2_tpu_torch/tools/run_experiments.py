"""Sequential experiment runner of the port (demo2_tpu's
tools/run_experiments.py; reference: run_sequential_experiments.py).

    python3 -m demo2_tpu_torch.tools.run_experiments [--experiments FILE.json] \
        [--stop_on_failure] [--report experiment_report.json]

Runs each experiment (name, config file, [KEY VALUE ...]) as its own
`python3 -m demo2_tpu_torch.tools.train --config_file CONFIG --exp_name NAME
OPTS` process, one after another (one card serves one run at a time), then
writes `--report` (each run's return code and seconds) and beside it a
Markdown table of each run's best mAP / Rank-1 and final loss from its
`<OUTPUT_DIR>/<name>_metrics.jsonl` (utils/metrics_log.py::
write_markdown_report).  The exit code is 0 only if every run succeeded.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional, Sequence

DEFAULT_EXPERIMENTS = [
    ("baseline", "configs/RGBNT201/Baseline.yml", []),
    ("sdtps", "configs/RGBNT201/DeMo_SDTPS.yml", []),
    ("dgaf_v3", "configs/RGBNT201/DeMo_DGAF.yml", []),
    ("sdtps_dgaf_v3", "configs/RGBNT201/DeMo_SDTPS_DGAF.yml", []),
]
# The directory that holds the package, put on the runs' PYTHONPATH.
PACKAGE_PARENT = str(Path(__file__).resolve().parents[2])


def run_experiment(name, config, opts, python=sys.executable) -> dict:
    cmd = [python, "-m", "demo2_tpu_torch.tools.train", "--config_file", config,
           "--exp_name", name] + list(opts)
    print(f"[{time.strftime('%H:%M:%S')}] starting {name}: {' '.join(cmd)}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_PARENT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.time()
    proc = subprocess.run(cmd, env=env)
    return {"name": name, "config": config, "returncode": proc.returncode,
            "seconds": round(time.time() - t0, 1)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run the experiments and write the reports; returns the exit code."""
    from ..config import get_cfg_defaults
    from ..utils.metrics_log import write_markdown_report

    parser = argparse.ArgumentParser()
    parser.add_argument("--experiments", type=str, default="",
                        help="JSON file with [[name, config, [opts...]], ...]")
    parser.add_argument("--stop_on_failure", action="store_true")
    parser.add_argument("--report", type=str, default="experiment_report.json")
    args = parser.parse_args(argv)

    experiments = (json.loads(Path(args.experiments).read_text()) if args.experiments
                   else DEFAULT_EXPERIMENTS)
    results = []
    for name, config, opts in experiments:
        res = run_experiment(name, config, list(opts))
        results.append(res)
        status = "OK" if res["returncode"] == 0 else f"FAILED({res['returncode']})"
        print(f"[{time.strftime('%H:%M:%S')}] {name}: {status} in {res['seconds']}s")
        if res["returncode"] != 0 and args.stop_on_failure:
            print("stopping on failure")
            break

    Path(args.report).write_text(json.dumps(results, indent=2))

    def output_dir(config, opts):
        cfg = get_cfg_defaults()
        if config:
            cfg.merge_from_file(config)
        cfg.merge_from_list(list(opts))
        return cfg.OUTPUT_DIR

    by_name = {name: (config, opts) for name, config, opts in experiments}
    md_path = str(Path(args.report).with_suffix(".md"))
    try:
        # Each run's OUTPUT_DIR comes from its config again: a bad config
        # (the runs that just failed) skips the report, not the summary.
        runs = {r["name"]: str(Path(output_dir(*by_name[r["name"]]))
                               / f"{r['name']}_metrics.jsonl") for r in results}
        print(f"markdown report -> {write_markdown_report(runs, md_path)}")
    except Exception as e:
        print(f"report generation skipped: {e}")
    print("\n===== SUMMARY =====")
    for r in results:
        print(f"  {r['name']:24s} rc={r['returncode']} {r['seconds']}s")
    ok = sum(1 for r in results if r["returncode"] == 0)
    print(f"{ok}/{len(results)} succeeded; report -> {args.report}")
    return 0 if ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
