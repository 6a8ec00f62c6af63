"""Tiny versions of the benchmark's configurations and mixes, for the CPU
tests: the same files with every size cut so that a whole run takes
seconds on the CPU."""

from __future__ import annotations

import torch

from portbench import manifest

torch.set_num_threads(max(1, min(4, torch.get_num_threads())))


def pt_l8():
    c = manifest.config("deepblast-pt-l8")
    c["lm"].update(d_model=32, d_kv=8, d_ff=64, num_layers=2, num_heads=4)
    c["heads"].update(embedding_dim=32, hidden_dim=32)
    return c


def _short(pairs, count):
    pairs.update(count=count)
    pairs["lengths"].update(median=30, min=10, max=80)


def fit_mix():
    m = manifest.mix("fit-tmalign")
    m["batch_size"] = 8
    _short(m["pairs"], 32)
    return m


def align_mix():
    m = manifest.mix("align-tmalign")
    _short(m["pairs"], 8)
    m["check_requests"] = 4
    return m


def nw_mix(name):
    m = manifest.mix(name)
    m["potentials"].update(batch=4, n=24, m=20)
    m["check_block"], m["check_pairs"] = 2, 2
    return m


#: cell -> (configuration or None for the file's, mix)
CELLS = {
    "pt-l8.train": (pt_l8, fit_mix),
    "pt-l8.align": (pt_l8, align_mix),
    "nw-layer.train-800": (None, lambda: nw_mix("train-800")),
    "nw-layer.train-4096": (None, lambda: nw_mix("train-4096")),
}


def cell(name):
    cfg, mix = CELLS[name]
    return (cfg() if cfg else None), mix()
