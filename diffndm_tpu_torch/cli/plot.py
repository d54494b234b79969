"""Violin plots of per-file metric distributions (the reference's
my_plot.py and my_plot_inpaint.py): evaluation reports parsed, one violin
per variant; or training curves from a metrics.jsonl stream.

Example:
    python -m diffndm_tpu_torch.cli.plot origin=o.txt SPSA=s.txt \
        --outdir plots/

``parse_report`` reads the ``cli.evaluate`` report; the plots need
matplotlib, imported only when a plot is drawn.
"""

from __future__ import annotations

import argparse
import json
import os
import re


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("reports", nargs="+",
                   help="label=report.txt pairs (e.g. origin=o.txt "
                        "SPSA=s.txt), or a single metrics.jsonl with "
                        "--curves")
    p.add_argument("--outdir", type=str, required=True)
    p.add_argument("--curves", action="store_true",
                   help="plot training curves from a metrics.jsonl "
                        "stream (every metric over steps, one panel each)")
    return p


_ROW = re.compile(r"QED=([\d.]+) SA=([\d.]+) LogP=(-?[\d.]+) "
                  r"Lipinski=([\d.]+)")


def parse_report(path: str):
    """The per-file (QED, SA, LogP, Lipinski) rows of a ``cli.evaluate``
    report; the AGGREGATE line is skipped."""
    rows = []
    with open(path) as f:
        for line in f:
            if line.startswith("AGGREGATE"):
                continue
            m = _ROW.search(line)
            if m:
                rows.append(tuple(float(v) for v in m.groups()))
    return rows


def _pyplot():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("cli.plot draws with matplotlib, which is not "
                          "installed here; parse_report needs none") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_curves(metrics_jsonl: str, outdir: str):
    """One panel per metric of the stream, the train / val / test splits
    overlaid."""
    plt = _pyplot()
    series = {}  # (split, key) -> (steps, values)
    with open(metrics_jsonl) as f:
        for line in f:
            rec = json.loads(line)
            for k, v in rec.items():
                if k in ("step", "split", "time", "epoch") or \
                        not isinstance(v, (int, float)):
                    continue
                steps, values = series.setdefault((rec["split"], k),
                                                  ([], []))
                steps.append(rec["step"])
                values.append(v)
    os.makedirs(outdir, exist_ok=True)
    for key in sorted({k for _, k in series}):
        fig, ax = plt.subplots(figsize=(5, 3.2))
        for split in ("train", "val", "test"):
            if (split, key) in series:
                xs, ys = series[(split, key)]
                ax.plot(xs, ys, marker="o", markersize=2, label=split)
        ax.set_xlabel("step")
        ax.set_ylabel(key)
        ax.legend()
        fig.tight_layout()
        out = os.path.join(outdir, f"curve_{key}.png")
        fig.savefig(out, dpi=120)
        plt.close(fig)
        print(f"wrote {out}")
    return 0


def plot_violins(reports, outdir: str):
    import numpy as np

    plt = _pyplot()
    data = {}
    for spec in reports:
        label, path = spec.split("=", 1)
        data[label] = parse_report(path)
    os.makedirs(outdir, exist_ok=True)
    for mi, metric in enumerate(["QED", "SA", "LogP", "Lipinski"]):
        fig, ax = plt.subplots(figsize=(1.5 * len(data) + 2, 4))
        series = [np.array([r[mi] for r in rows]) if rows else np.zeros(1)
                  for rows in data.values()]
        ax.violinplot(series, showmeans=True)
        ax.set_xticks(range(1, len(data) + 1))
        ax.set_xticklabels(list(data))
        ax.set_title(metric)
        out = os.path.join(outdir, f"{metric.lower()}_violin.png")
        fig.savefig(out, dpi=120, bbox_inches="tight")
        plt.close(fig)
        print("wrote", out)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.curves:
        return plot_curves(args.reports[0], args.outdir)
    plot_violins(args.reports, args.outdir)


if __name__ == "__main__":
    main()
