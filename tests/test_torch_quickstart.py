"""``python -m repro_torch.quickstart --device cpu`` (the counterpart of
``examples/quickstart.py``): three FedCGD rounds over 16 devices on the
reduced paper CNN, each record finite and consistent."""
import math

from repro_torch.quickstart import main


def test_quickstart_runs_three_rounds_on_cpu(capsys):
    records = main(["--device", "cpu"])
    assert len(records) == 3
    for rec in records:
        assert 0 <= rec["num_scheduled"] <= rec["num_available"] <= 16
        assert math.isfinite(rec["wemd"])
        assert math.isfinite(rec["sampling_variance"])
        assert 0.0 <= rec["test_accuracy"] <= 1.0
    assert capsys.readouterr().out.count("round ") == 3
