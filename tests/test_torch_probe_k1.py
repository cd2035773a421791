"""The K1 route probe (``python -m lp_gnn_tpu_torch.probe_k1_route``) on
the CPU: two gloo ranks at a tiny shape (its sizes patched). There K1's
rank form is its plain version, one ``all_to_all_single`` an exchange,
which is what the probe must find inside each exchange; the card's figures
(``events_ms``) are null. The probe's figures on the card come from chip
runs only."""
import json

from lp_gnn_tpu_torch import probe_k1_route


def test_probe_k1_route_on_cpu_ranks(monkeypatch, capsys):
    monkeypatch.setattr(probe_k1_route, "RANKS", 2)
    monkeypatch.setattr(probe_k1_route, "BENCH_BH", 12)
    monkeypatch.setattr(probe_k1_route, "DIMS", (8, 3))
    monkeypatch.setattr(probe_k1_route, "ITERS", 3)
    probe_k1_route.main(["--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["device"] == "cpu" and line["ranks"] == 2
    assert line["Bh"] == 12 and line["dtype"] == "bfloat16"
    assert sorted(line["cases"]) == ["3", "8"]
    for ranks in line["cases"].values():
        assert len(ranks) == 2
        for r in ranks:
            assert r["parts_calls"] == {
                "torch.distributed.all_to_all_single": 1.0}
            assert len(r["exchange_ms_each"]) == 3
            assert r["exchange_ms"] >= r["parts_ms"][
                "torch.distributed.all_to_all_single"] > 0
            assert r["events_ms"] is None
