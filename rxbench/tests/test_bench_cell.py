"""The harness finds each cell's configuration, traffic, limits and metric
readers by the names in BENCHMARK.json, and the file keeps to its
contract's shape."""

import json
import re

import pytest

from rxbench import harness, reference

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.Cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["kind"] == cell.workload["traffic"]
    assert set(cell.limits) == set(reference.NUMBERS)
    assert cell.file_s > 0
    names = {m["name"] for m in cell.per_layer}
    assert names == {m["name"] for m in BENCH["per_layer"]}
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))


def test_unknown_workload_refused():
    with pytest.raises(KeyError):
        harness.Cell("nonesuch.replay")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and c["reduced"] == []
        assert c["file"].startswith("rxbench/")
        assert json.loads((harness.ROOT / c["file"]).read_text())["name"] \
            == c["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert w["chips"] == 1
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert NAME.match(m["name"]) and m["moves"] in e2e
        assert (harness.HERE / "metrics" / f"{m['name']}.py").exists()


@pytest.mark.parametrize("off_hz, unlocked", [(40.0, 1), (-120.0, 1),
                                              (300.0, 0)])
def test_unlocked_counts_starts_at_the_nearest_bin(off_hz, unlocked):
    """A satellite started at its Doppler that never locks is counted; one
    started a bin off (the search's noise) is not."""
    from rxbench.drive import FileAnswers

    cell = harness.Cell("dual16.replay")
    geos = harness.make_geometries(cell.config, 2 * cell.file_s)
    tr = reference._truths(cell.config, geos, cell.file_s)["E"]
    prn = tr.geo.prns[0]
    ans = FileAnswers(index=1, seconds_fed=30, complete=True)
    ans.starts = [(2, "E", prn, tr.doppler_hz(prn, 1, int(2 * tr.fs))
                   + off_hz)]
    got = reference.judge(cell.config, geos, [ans], cell.file_s)
    assert got["sats_unlocked"] == unlocked
