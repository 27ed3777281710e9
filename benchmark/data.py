"""The benchmark's inputs: a configuration's graph files, cached in the
checkout, and a traffic mix's read files, made from the run's seed.

A configuration file (`configs/<name>.json`) gives the graph generator's
parameters (genome_len, genome_seed, snp_rate; `gen/synth.py`), the
mapper's (k, m, e, mode, index_layout, mesh, batch_size) and `chips`.
Its unitig FASTA, and its saved index where a traffic mix loads one,
are made once per checkout under `build/benchmark/<config>/<key>/`, the
key a hash of those parameters and of the generator's source; later runs
load them.  The index is saved by the program's own command line
(`--save-index`), in the configuration's layout.

A traffic file (`traffic/<name>.json`) gives the reads of one job: how
many (`reads`), their length, the substitution rate a base
(`sub_rate`), and whether each job loads the saved index (`index`:
"load") or builds it from the unitig FASTA (`index`: "build").  Every
job of a run maps the same read file, made from `--seed`; the warm-up
maps one batch of reads drawn the same way from another stream of it.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from .gen import synth

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "benchmark"
GRAPH_KEYS = ("genome_len", "genome_seed", "snp_rate", "k")


@dataclass
class GraphFiles:
    unitigs: Path
    index: Path | None
    min_unitig_len: int      # shortest unitig of the FASTA
    n_unitigs: int


def _key(config: dict) -> str:
    src = (BENCH / "gen" / "synth.py").read_bytes()
    blob = json.dumps([config[k] for k in GRAPH_KEYS])
    return hashlib.sha256(blob.encode() + src).hexdigest()[:16]


def haplotypes_of(config: dict) -> tuple[np.ndarray, np.ndarray]:
    """(uint8 [2, n] haplotypes, SNP positions) of the configuration."""
    rng = np.random.default_rng(config["genome_seed"])
    genome = synth.make_genome(rng, config["genome_len"])
    sites = synth.snp_sites(genome, rng, config["k"], config["snp_rate"])
    return synth.haplotypes(genome, sites), sites[0]


def _write(path: Path, blob: bytes) -> None:
    part = path.with_name(path.name + ".part")
    part.write_bytes(blob)
    os.replace(part, path)


def graph_files(config: dict, with_index: bool, map_job,
                cache: Path = CACHE) -> GraphFiles:
    """The configuration's unitig FASTA (made here if missing) and, with
    `with_index`, its saved index, made by `map_job(argv)`: one call of
    the program's command line on a read file of 16 reads with
    `--save-index`."""
    d = cache / config["name"] / _key(config)
    d.mkdir(parents=True, exist_ok=True)
    unitigs = d / "unitigs.fa"
    meta = d / "unitigs.json"
    if not unitigs.exists() or not meta.exists():
        haps, pos = haplotypes_of(config)
        rng = np.random.default_rng([config["genome_seed"], 1])
        blob = synth.unitig_fasta(haps, pos, config["k"], rng)
        seqs = blob.split(b"\n")[1::2]
        _write(unitigs, blob)
        _write(meta, json.dumps({"min_len": min(len(s) for s in seqs),
                                 "n": len(seqs)}).encode())
    index = None
    if with_index:
        index = d / f"index.{config['index_layout']}.npz"
        if not index.exists():
            reads = d / "save_reads.fa"
            haps, _ = haplotypes_of(config)
            _write(reads, synth.reads_fasta(synth.sample_reads(
                haps, np.random.default_rng(0), 16)))
            part = d / f"index.{config['index_layout']}.part.npz"
            map_job(["-r", str(reads), "-k", str(config["k"]),
                     "-g", str(unitigs), "--index-layout",
                     config["index_layout"], "--save-index", str(part),
                     "-f", str(d / "save_paths"),
                     "-a", str(d / "save_notAligned.fa")])
            os.replace(part, index)
    m = json.loads(meta.read_text())
    return GraphFiles(unitigs, index, m["min_len"], m["n"])


def make_reads(config: dict, traffic: dict, seed: int, path: Path,
               warm: Path) -> int:
    """Writes the traffic's read FASTA for `seed` to `path`, and one
    batch of reads drawn alike to `warm`; returns the number of reads of
    `path`."""
    haps, _ = haplotypes_of(config)
    for n, out, stream in ((traffic["reads"], path, 0),
                           (min(traffic["reads"], config["batch_size"]),
                            warm, 1)):
        rng = np.random.default_rng([config["genome_seed"], seed % 2 ** 63,
                                     stream])
        out.write_bytes(synth.reads_fasta(synth.sample_reads(
            haps, rng, n, traffic["read_len"], traffic["sub_rate"])))
    return traffic["reads"]
