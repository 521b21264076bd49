"""Cells of the benchmark cut to debug widths for the CPU tests: the cell's
own configuration file, traffic kind and limits, every width and length
small."""

from __future__ import annotations

import copy

from harness.manifest import Cell, load_cell


def lm_cell(name: str = "lm_best.train") -> Cell:
    c = load_cell(name)
    cfg = copy.deepcopy(c.config)
    cfg["run"]["model"].update(emb_dim=32, dim=32, n_layers=2)
    traffic = dict(c.traffic, rows=8, min_tokens=10, max_tokens=20, pool=4)
    return c._replace(config=cfg, traffic=traffic)


def asr_cell(width: int = 16) -> Cell:
    c = load_cell("asr_best.train")
    cfg = copy.deepcopy(c.config)
    m = cfg["run"]["model"]
    m["encoder"].update(dim=[width] * 2, dropout=[0.3] * 2,
                        layer_norm=[False] * 2, proj=[True] * 2,
                        sample_rate=[1] * 2)
    m["attention"].update(dim=8, loc_kernel_size=5, loc_kernel_num=3)
    m["decoder"].update(dim=width)
    traffic = dict(c.traffic, rows=4, min_seconds=1.0, max_seconds=2.0,
                   min_chars=6, max_chars=12, buckets_sec=[[2.0, 48]],
                   pool=3)
    return c._replace(config=cfg, traffic=traffic)
