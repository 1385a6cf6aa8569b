"""Cells for the benchmark's own tests (``python3 -m pytest
portbench/tests``; the repository's ``tests/`` run does not collect them):
the cells of BENCHMARK.json, and those kept as files only, at a size the
CPU runs in a second or two."""

import json

from portbench import spec

SHARD = 4096

#: cells whose files are here but that BENCHMARK.json does not list:
#: name -> (config, traffic, end-to-end metrics, per-layer metrics)
UNLISTED = {
    "ec-write": ("ec-rs12-4", "ec-write",
                 [("write_gibps", "GiB/s"), ("setup_s", "s")],
                 [("write_p95_ms.write", "ms"),
                  ("meta_ms_per_file.write", "ms"),
                  ("encode_ms_per_gib.write", "ms/GiB"),
                  ("launches_per_gib.write", "1/GiB"),
                  ("encode_roofline.write", "%"), ("crc_roofline.write", "%"),
                  ("device_idle.write", "%")]),
}


def load_cell(name: str) -> spec.Cell:
    """A cell of BENCHMARK.json, or one of ``UNLISTED`` from its files."""
    if name not in UNLISTED:
        return spec.load_cell(name, spec.find_root())
    config, traffic, e2e, layers = UNLISTED[name]
    return spec.Cell(
        name=name,
        config=json.loads((spec.PKG / "configs" / f"{config}.json")
                          .read_text()),
        traffic=json.loads((spec.PKG / "traffic" / f"{traffic}.json")
                           .read_text()),
        chips=1,
        end_to_end=[{"name": n, "unit": u} for n, u in e2e],
        per_layer=[{"name": n, "unit": u} for n, u in layers])


def tiny_cell(name: str):
    """A cell at a size the CPU runs in a second or two: 4 KiB shards and
    files of 8 stripes, every count of the mix kept."""
    cell = load_cell(name)
    c, t = dict(cell.config), dict(cell.traffic)
    c.update(shard_size=SHARD, chunk_size=c["ec_k"] * SHARD)
    t.update(call_bytes=2 * c["chunk_size"], file_bytes=8 * c["chunk_size"],
             engine_prealloc_mb=0)
    cell.config, cell.traffic = c, t
    return cell
