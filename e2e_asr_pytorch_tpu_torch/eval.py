"""Offline WER/CER scoring of the decode CSVs, without pandas.

    python -m e2e_asr_pytorch_tpu_torch.eval --file result/<exp>_<split>_output.csv
    python -m e2e_asr_pytorch_tpu_torch.eval --beam --file result/<exp>_<split>_beam.csv

The first form reads the idx/hyp/truth TSV the test solver writes and
prints corpus-level error rates and length stats, as the repo's ``eval.py``
does; ``--beam`` reads the idx/beam/hyp/truth TSV and scores, per utterance,
the minimum error across beams (the oracle), as ``eval_beam.py`` does. The
TSV is read with the ``csv`` module under pandas' default quoting, and every
field stays a string: an empty hypothesis is the empty string.
"""

from __future__ import annotations

import argparse
import csv
from typing import Dict, List, Tuple

from e2e_asr_pytorch_tpu_torch.utils.metrics import cer_strings, wer_strings


def read_tsv(path: str) -> List[Dict[str, str]]:
    """The rows of a tab-separated file with a header, as dicts of strings
    (blank lines skipped)."""
    with open(path, newline="") as f:
        rows = [r for r in csv.reader(f, delimiter="\t") if r]
    return [dict(zip(rows[0], r)) for r in rows[1:]]


def score_output(path: str) -> Tuple[float, float]:
    """Mean WER and CER over the utterances of an ``_output.csv``."""
    wers, cers, hyp_lens, truth_lens = [], [], [], []
    for row in read_tsv(path):
        hyp, truth = row["hyp"], row["truth"]
        wers.append(wer_strings(hyp, truth))
        cers.append(cer_strings(hyp, truth))
        hyp_lens.append(len(hyp.split()))
        truth_lens.append(len(truth.split()))
    n = max(len(wers), 1)
    print("Evaluating {} ({} utterances)".format(path, len(wers)))
    print("WER: {:.4f}".format(sum(wers) / n))
    print("CER: {:.4f}".format(sum(cers) / n))
    print("Avg hyp/truth length (words): {:.1f} / {:.1f}".format(
        sum(hyp_lens) / n, sum(truth_lens) / n))
    return sum(wers) / n, sum(cers) / n


def score_beam(path: str) -> Tuple[float, float]:
    """Oracle WER and CER of a ``_beam.csv``: per utterance, the best
    beam's."""
    groups: Dict[str, List[Dict[str, str]]] = {}
    for row in read_tsv(path):
        groups.setdefault(row["idx"], []).append(row)
    wers, cers = [], []
    for rows in groups.values():
        truth = rows[0]["truth"]
        wers.append(min(wer_strings(r["hyp"], truth) for r in rows))
        cers.append(min(cer_strings(r["hyp"], truth) for r in rows))
    n = max(len(wers), 1)
    print("Oracle evaluation of {} ({} utterances)".format(path, len(wers)))
    print("Oracle WER: {:.4f}".format(sum(wers) / n))
    print("Oracle CER: {:.4f}".format(sum(cers) / n))
    return sum(wers) / n, sum(cers) / n


def main(argv=None) -> Tuple[float, float]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--file", type=str, required=True,
                    help="decode output csv (idx\\thyp\\ttruth), or with "
                         "--beam a beam csv (idx\\tbeam\\thyp\\ttruth)")
    ap.add_argument("--beam", action="store_true",
                    help="oracle scoring over all beams of a _beam.csv")
    args = ap.parse_args(argv)
    return score_beam(args.file) if args.beam else score_output(args.file)


if __name__ == "__main__":
    main()
