"""examples/model/torch_train_black_scholes.py (PyTorch) against the JAX
package's training script, examples/model/train_black_scholes.py, on the
CPU.  The reference script is loaded from its file for its functions; its
main() (3000 steps, then a write of examples/model/weights.npz) is never
called.  Tolerances: the data bit for bit; after 20 Adam steps from the
same float32 weights, each parameter within rtol 1e-4 of optax's, as the
norm of the difference over the norm of optax's tensor.  The two
frameworks sum float32 products in other orders, and Adam's normalised
step turns that noise into a relative error of up to 3e-3 in an element
near 0 (one of w2's, seen here), 8e-6 over a whole tensor."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
optax = pytest.importorskip("optax")
import jax.numpy as jnp  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WEIGHTS = ROOT / "examples" / "model" / "weights.npz"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"test_train_{name}", ROOT / "examples" / "model" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load("train_black_scholes")
PORT = _load("torch_train_black_scholes")


def test_training_data_equals_the_reference_scripts():
    rng = np.random.default_rng(7)
    S = rng.uniform(1.0, 40.0, size=4096)
    t = rng.uniform(0.01, REF.T_MAX, size=4096)
    y = REF.bs_call_price(S, t)
    X, Y = PORT.training_data()
    assert X.dtype == Y.dtype == np.float32 and X.shape == (4096, 2) and Y.shape == (4096, 1)
    assert X.tobytes() == np.stack([S, t], axis=1).astype(np.float32).tobytes()
    assert Y.tobytes() == y.reshape(-1, 1).astype(np.float32).tobytes()


@pytest.mark.parametrize("name", ["bs_call_price", "bs_call_price_noscipy"])
def test_call_price_equals_the_reference_scripts(name):
    rng = np.random.default_rng(3)
    S, t = rng.uniform(1.0, 40.0, size=257), rng.uniform(0.0, 1.0, size=257)
    assert getattr(PORT, name)(S, t).tobytes() == getattr(REF, name)(S, t).tobytes()


def test_init_params_is_seeded_and_scaled():
    a, b, c = PORT.init_params(0), PORT.init_params(0), PORT.init_params(1)
    wa, wb, wc = PORT.weights_of(a), PORT.weights_of(b), PORT.weights_of(c)
    assert list(wa) == ["w1", "b1", "w2", "b2", "w3", "b3"]
    assert all(np.array_equal(wa[k], wb[k]) for k in wa)
    assert not np.array_equal(wa["w2"], wc["w2"])
    assert all(not wa[f"b{i}"].any() for i in (1, 2, 3))
    assert abs(np.std(wa["w2"]) * 8 - 1) < 0.05  # randn / sqrt(64)


def _optax_steps(w0: dict, steps: int) -> dict:
    """The reference script's loss and step (its main()), from w0."""

    def forward(p, x):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        h = jnp.tanh(h @ p["w2"] + p["b2"])
        return h @ p["w3"] + p["b3"]

    def loss(p, x, y):
        return jnp.mean((forward(p, x) - y) ** 2)

    opt = optax.adam(1e-3)

    @jax.jit
    def step(p, s, x, y):
        l, g = jax.value_and_grad(loss)(p, x, y)
        upd, s = opt.update(g, s)
        return optax.apply_updates(p, upd), s, l

    params = {k: jnp.asarray(v) for k, v in w0.items()}
    state = opt.init(params)
    X, Y = PORT.training_data()
    for _ in range(steps):
        params, state, _ = step(params, state, jnp.asarray(X), jnp.asarray(Y))
    return {k: np.asarray(v) for k, v in params.items()}


def test_twenty_adam_steps_match_optax():
    w0 = {k: v.detach().numpy() for k, v in PORT.init_params(0).named_parameters()}
    want = _optax_steps(w0, 20)
    before = torch.get_float32_matmul_precision()
    model, losses = PORT.train(20, device="cpu")
    assert torch.get_float32_matmul_precision() == before
    assert losses.shape == (21,) and losses[-1] < losses[0]
    got = {k: v.detach().numpy() for k, v in model.named_parameters()}
    for k in want:
        assert np.linalg.norm(got[k] - want[k]) <= 1e-4 * np.linalg.norm(want[k]), k


def test_save_weights_gives_what_load_weights_reads(tmp_path):
    from luminair_tpu_torch.models import black_scholes

    path = tmp_path / "w.npz"
    PORT.save_weights(PORT.init_params(0), path)
    got, want = np.load(path), black_scholes.load_weights()
    assert sorted(got.files) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float64 and got[k].shape == want[k].shape, k


def test_cli_writes_only_where_told(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert PORT.main(["--steps", "2", "--device", "cpu"]) == 0
    assert list(tmp_path.iterdir()) == []
    out = tmp_path / "w.npz"
    assert PORT.main(["--steps", "2", "--device", "cpu", "--out", str(out)]) == 0
    assert list(tmp_path.iterdir()) == [out] and f"saved {out}" in capsys.readouterr().out


def test_train_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT.train(1)


def test_no_weights_file_was_written():
    """Last in this file: nothing above wrote the PINN's weights file."""
    assert not WEIGHTS.exists()
