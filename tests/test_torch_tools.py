"""The port's companion tools (dbgtpu_torch/tools, copies of
dbgtpu/tools) against dbgtpu's on the same bytes."""

import io

import pytest

import dbgtpu.tools.convert_one_line
import dbgtpu.tools.dbg_construction
import dbgtpu.tools.get_large_unitigs
import dbgtpu.tools.ggmap
import dbgtpu.tools.no_n
import dbgtpu_torch.cli
import dbgtpu_torch.tools.convert_one_line
import dbgtpu_torch.tools.dbg_construction
import dbgtpu_torch.tools.get_large_unitigs
import dbgtpu_torch.tools.ggmap
import dbgtpu_torch.tools.no_n
from dbgtpu.pipeline import run_pipeline as dbgtpu_pipeline

from . import synth

FASTA = (b">u1\nACGTACGTACGT\nACGT\n>u2\nacg\n>u3\nggggccNcaaaa\n"
         b">u4\nTTTTTTTTTTTTTTTTTTTT\n")


@pytest.mark.parametrize("min_len", [1, 5, 13, 100])
def test_get_large_unitigs_equal(tmp_path, min_len):
    inp = tmp_path / "u.fa"
    inp.write_bytes(b">u1\nACGTACGTACGT\n>u2\nacg\n>u3\nggggccccaaaa\n")
    outs = []
    for mod in (dbgtpu.tools.get_large_unitigs,
                dbgtpu_torch.tools.get_large_unitigs):
        out = tmp_path / f"{mod.__name__}.fa"
        mod.get_large_unitigs(str(inp), str(out), min_len)
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    if min_len == 5:
        assert outs[1] == b">N\nACGTACGTACGTGGGGCCCCAAAA\n"


@pytest.mark.parametrize("tool,fn", [("convert_one_line", "convert"),
                                     ("no_n", "no_n")])
def test_stream_tools_equal(tool, fn):
    outs = []
    for pkg in (dbgtpu.tools, dbgtpu_torch.tools):
        dst = io.BytesIO()
        getattr(getattr(pkg, tool), fn)(io.BytesIO(FASTA), dst)
        outs.append(dst.getvalue())
    assert outs[0] == outs[1] and outs[1]
    assert (b"N" not in outs[1]) if tool == "no_n" else (
        outs[1].count(b"\n") == 8)


def test_dbg_construction_equal(monkeypatch, capsys):
    """No construction tool here: both stop the same way; usage too."""
    monkeypatch.setenv("PATH", "")
    for mod in (dbgtpu.tools.dbg_construction,
                dbgtpu_torch.tools.dbg_construction):
        assert mod.main(["reads.fa"]) == 2
        assert "usage: dbg_construction" in capsys.readouterr().err
        with pytest.raises(SystemExit, match="no graph construction tool"):
            mod.main(["reads.fa", "21", "2", "out"])
        assert not mod.have("bcalm")


def test_ggmap_maps_with_the_ports_cli(tmp_path, monkeypatch, capsys):
    """ggmap calls dbgtpu_torch.cli.main (here pointed at the CPU) and
    writes the large-unitig reference as dbgtpu's does."""
    reads_fa, unitigs_fa = synth.make_dataset(
        seed=91, genome_len=8000, k=21, n_reads=60, n_frac=0.1)
    (tmp_path / "r.fa").write_bytes(reads_fa)
    (tmp_path / "u.fa").write_bytes(unitigs_fa)
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("PATH", "")          # no bowtie2: phase 2 stops early
    assert dbgtpu_torch.tools.ggmap.main(["r.fa"]) == 2
    seen = []
    real = dbgtpu_torch.cli.main

    def on_cpu(argv):
        seen.append(list(argv))
        return real(list(argv) + ["--device", "cpu"])

    monkeypatch.setattr(dbgtpu_torch.cli, "main", on_cpu)
    assert dbgtpu_torch.tools.ggmap.main(["r.fa", "u.fa", "21", "60"]) == 0
    assert seen == [["-r", "r.fa", "-g", "u.fa", "-k", "21"]]
    want = dbgtpu_pipeline(["r.fa"], "u.fa", k=21, impl="python")
    assert (tmp_path / "paths").read_bytes() == want[0]
    assert (tmp_path / "notAligned.fa").read_bytes() == want[1]
    big = (tmp_path / "big.fa").read_bytes()
    dbgtpu.tools.get_large_unitigs.get_large_unitigs("u.fa", "big_ref.fa", 60)
    assert big == (tmp_path / "big_ref.fa").read_bytes() and len(big) > 100
    assert "PHASE 2" in capsys.readouterr().out
    # without a card (and without --device cpu) the mapper stops, and
    # ggmap with it
    monkeypatch.setattr(dbgtpu_torch.cli, "main", lambda argv: 1)
    assert dbgtpu_torch.tools.ggmap.main(["r.fa", "u.fa", "21"]) == 1
