"""The port's training launchers on the CPU: ``launch.train`` (a run
checkpointed every 2 steps, then resumed from its newest checkpoint with
the watchdog on) and ``launch.train_lm --fast`` (the ~20M-parameter
qwen2-family model, a simulated preemption and resume, the loss
decreasing)."""
import signal

import numpy as np

from repro_torch.launch import train as train_launcher
from repro_torch.launch import train_lm
from repro_torch.train import checkpoint as ckpt


def test_train_launcher_resumes_on_the_cpu(tmp_path, capsys):
    old = signal.getsignal(signal.SIGTERM)
    try:
        args = ["--arch", "qwen2-7b", "--seq-len", "32", "--batch", "4",
                "--microbatches", "2", "--log-every", "1", "--device", "cpu",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
        assert train_launcher.main(args + ["--steps", "3"]) == 0
        assert ckpt.latest_step(str(tmp_path)) == 3
        assert train_launcher.main(args + ["--steps", "5",
                                           "--watchdog"]) == 0
    finally:
        signal.signal(signal.SIGTERM, old)
    out = capsys.readouterr().out
    assert "[resume] restored step 3" in out
    assert ckpt.latest_step(str(tmp_path)) == 5
    losses = [float(line.split()[3]) for line in out.splitlines()
              if line.startswith("step")]
    assert len(losses) == 5 and all(np.isfinite(losses))


def test_train_lm_example_on_the_cpu(tmp_path, capsys):
    assert train_lm.main(["--fast", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "== resumed from step 20 ==" in out
    first, final = (float(x) for x in
                    out.split("loss ")[-1].split(" over")[0].split(" -> "))
    assert final < first
