"""chip_smoke.py refuses to run anywhere but on a GPU: no phase runs and no
result line is printed."""
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def test_require_gpu_refuses_cpu():
    import chip_smoke

    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.require_gpu()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_exits_nonzero_without_gpu(tmp_path, alone):
    """From the checkout on the CPU, and copied into a directory that holds
    nothing else of the repo: nonzero exit, no JSON result line."""
    script = os.path.join(REPO, "chip_smoke.py")
    if alone:
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run([sys.executable, str(script)], capture_output=True,
                         text=True, cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_large_mesh_checks_on_virtual_devices(capsys):
    """The four-card config-4 comparison at a miniature of config 4 on four
    virtual CPU devices: float32 traces compared where float32 resolves
    them, float64 objectives of the returned iterates to rtol 1e-4."""
    import jax

    import chip_smoke

    if len(jax.devices()) < 4:
        pytest.skip("needs four devices")
    chip_smoke._large_mesh_checks(num_blocks=4000, m=16384)
    out = capsys.readouterr().out
    assert out.count("resolved iterations max rel") == 2
    assert out.count("float64 mesh") == 2


def test_f32_resolved_floor_scales_with_b():
    """The float32 resolution floor is 0.5 (eps32 ||b|| / 1e-4)^2 per
    scenario."""
    import types

    import numpy as np

    import chip_smoke

    b = np.array([[3.0, 4.0], [0.0, 1.0]])
    got = chip_smoke._f32_resolved_floor(types.SimpleNamespace(b=b))
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(got, 0.5 * (eps * np.array([5.0, 1.0]) / 1e-4) ** 2)
