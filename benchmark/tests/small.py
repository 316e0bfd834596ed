"""A cell of ``BENCHMARK.json`` at a size the CPU tests can hold: every
width scaled as the program's generators scale it (``width``), one block
per stage (``full_depth`` keeps the configuration's blocks, and its
embedding width), a handful of species, and short recordings."""

from __future__ import annotations

import copy

from benchmark.harness import spec


def ch(c: int, width: float) -> int:
    return max(8, int(c * width) // 8 * 8)


def small_cell(workload: str, width: float = 0.1, species: int = 24,
               recording_seconds: float = 12.0, full_depth: bool = False,
               **traffic) -> spec.Cell:
    cell = copy.deepcopy(spec.load(workload))
    cfg = cell.config
    cfg["stem_channels"] = ch(cfg["stem_channels"], width)
    cfg["stages"] = [[ch(c, width), e, k, s] for c, e, k, s in cfg["stages"]]
    cfg["head_channels"] = ch(cfg["head_channels"], width)
    if full_depth:
        # The configuration's blocks per stage and embedding width.
        cfg["head_channels"] = cfg.get("embedding_dim") or cfg["head_channels"]
    else:
        cfg["repeats"] = [1] * len(cfg["stages"])
        if cfg.get("embedding_dim"):
            cfg["embedding_dim"] = cfg["head_channels"] = 48
    cfg["num_species"] = species
    cell.traffic.update({"recording_seconds": recording_seconds, "check_every": 1, **traffic})
    return cell
