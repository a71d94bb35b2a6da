"""Word-count histograms of human vs synthetic captions (the port's own
copy of clipcap_tpu/tools/len_distribution.py; host only, matplotlib
imported inside the function).

Rebuild of reference len_distributon.py:18-48: read gt.csv from
human-eval output folders, split rows by the `human` flag, plot word-count
histograms to png+svg.
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path


def process_folder(folder_name: str, out_dir: str = ".") -> dict:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    gt_path = Path(folder_name) / "gt.csv"
    human_captions, synthetic_captions = [], []
    with open(gt_path, newline="") as f:
        reader = csv.reader(f)
        next(reader)  # header
        for row in reader:
            if row[2] == "True":
                human_captions.append(row[3])
            else:
                synthetic_captions.append(row[4])

    human_lengths = [len(s.split(" ")) for s in human_captions]
    synth_lengths = [len(s.split(" ")) for s in synthetic_captions]

    plt.figure(figsize=(8, 6))
    plt.hist([human_lengths, synth_lengths], alpha=1.0, label=["Human", "Synthetic"])
    plt.xlabel("Word count", size=14)
    plt.ylabel("Frequency", size=14)
    plt.title(f"Captions Lengths Histogram {folder_name}")
    plt.legend(loc="upper right")

    stem = Path(out_dir) / f"word_count_hist_{Path(folder_name).name}."
    plt.savefig(f"{stem}png")
    plt.savefig(f"{stem}svg")
    plt.close()
    return {"human": human_lengths, "synthetic": synth_lengths}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("folders", nargs="+", help="human-eval output folders with gt.csv")
    p.add_argument("--out_dir", default=".")
    args = p.parse_args(argv)
    for folder in args.folders:
        process_folder(folder, args.out_dir)


if __name__ == "__main__":
    main()
