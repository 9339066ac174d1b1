"""The port's LPIPS converter CLI (my_depthsplat_torch/convert/lpips_cli.py)
against the JAX package's (my_depthsplat_tpu/convert/lpips_cli.py), on a
seeded synthetic ``lpips.LPIPS(net='vgg')`` state dict: the port's LPIPS net
with seeded weights plus the keys the lpips package adds (the scaling
layer's buffers, the ``lins`` alias).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from my_depthsplat_tpu.convert import lpips_cli as jax_cli
from my_depthsplat_torch.convert import lpips_cli as port_cli
from my_depthsplat_torch.train import LPIPS, load_lpips_weights

from test_torch_train_cli import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = Path(__file__).resolve().parent.parent


def lpips_state_dict(path: Path) -> dict:
    """A seeded lpips VGG state dict with the lpips package's extra keys,
    saved at ``path``."""
    sd = dict(LPIPS(seed=3).state_dict())
    sd["scaling_layer.shift"] = torch.tensor([-0.030, -0.088, -0.188])[None, :, None, None]
    sd["scaling_layer.scale"] = torch.tensor([0.458, 0.448, 0.450])[None, :, None, None]
    for i in range(5):
        sd[f"lins.{i}.model.1.weight"] = sd[f"lin{i}.model.1.weight"]
    torch.save(sd, path)
    return sd


def test_cli_writes_the_jax_packages_npz(tmp_path, monkeypatch):
    """``python -m my_depthsplat_torch.convert.lpips_cli in.pth out.npz``
    writes the JAX CLI's .npz key for key (the same order) and bit for
    bit."""
    lpips_state_dict(tmp_path / "vgg.pth")
    monkeypatch.setattr(sys, "argv", ["lpips_cli", str(tmp_path / "vgg.pth"), str(tmp_path / "jax.npz")])
    jax_cli.main()
    done = subprocess.run(
        [sys.executable, "-m", "my_depthsplat_torch.convert.lpips_cli", str(tmp_path / "vgg.pth"),
         str(tmp_path / "port.npz")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert done.returncode == 0, done.stderr
    assert "wrote" in done.stdout
    want, got = np.load(tmp_path / "jax.npz"), np.load(tmp_path / "port.npz")
    assert got.files == want.files and len(got.files) == 31
    for key in want.files:
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape, key
        assert got[key].tobytes() == want[key].tobytes(), key


def test_npz_loads_to_the_state_dict(tmp_path):
    """The port's ``load_lpips_weights`` reads the written .npz back to the
    module state the .pth itself gives, tensor for tensor."""
    sd = lpips_state_dict(tmp_path / "vgg.pth")
    port_cli.main([str(tmp_path / "vgg.pth"), str(tmp_path / "vgg.npz")])
    from_npz = load_lpips_weights(LPIPS(), tmp_path / "vgg.npz").state_dict()
    from_pth = load_lpips_weights(LPIPS(), tmp_path / "vgg.pth").state_dict()
    assert from_npz.keys() == from_pth.keys()
    for key, value in from_pth.items():
        assert torch.equal(from_npz[key], value) and torch.equal(value, sd[key]), key


def test_converter_imports_nothing_of_jax():
    """The port's converter imports neither JAX nor the JAX package."""
    code = (
        "import sys, my_depthsplat_torch.convert.lpips_cli; "
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'my_depthsplat_tpu')]; "
        "assert not bad, bad"
    )
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert done.returncode == 0, done.stderr
