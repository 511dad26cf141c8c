"""``chip_smoke.py`` refuses to run without a GPU: it exits non-zero and
prints no verdict line, whether it finds only a CPU or finds itself
without the rest of the repository."""
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_on_cpu():
    res = _run(ROOT, SCRIPT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    assert "no GPU" in res.stderr


def test_chip_smoke_fails_alone(tmp_path):
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, alone)
    res = _run(str(tmp_path), str(alone))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
