"""Rules of the port: it never imports JAX or the JAX package, its entry
points refuse to run quietly on the CPU, and clearing the engine's logits
drops the device copy too."""

import ast
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import ctransformers_tpu_torch as T
from ctransformers_tpu_torch.engine.engine import Engine
from ctransformers_tpu_torch.models.llama_gguf import load_bundle

from .fixtures import build_llama_ggjt, build_llama_gguf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "ctransformers_tpu")


def _port_sources():
    pkg = os.path.join(ROOT, "ctransformers_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    scripts = os.path.join(ROOT, "scripts")
    for f in sorted(os.listdir(scripts)):
        if f.startswith("torch_") and f.endswith(".py"):
            yield os.path.join(scripts, f)


def test_sources_import_neither_jax_nor_the_jax_package():
    bad = []
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, ROOT)}:{node.lineno} {name}")
    assert not bad, bad


def test_shipped_data_files_belong_to_the_port():
    """The package's data files are the port's own: no file of the JAX
    package (its TPU tile tables) is shipped or named in them."""
    data = os.path.join(ROOT, "ctransformers_tpu_torch", "data")
    names = sorted(os.listdir(data))
    assert names and all(n.startswith("qmm_modes_") and n.endswith(".json") for n in names)
    for n in names:
        text = open(os.path.join(data, n)).read().lower()
        assert not [w for w in ("jax", "qmm_tiles", "v5e", "xla") if w in text], n


def test_fresh_process_loads_without_jax(tmp_path):
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path)
    code = textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {ROOT!r})
        import ctransformers_tpu_torch as T
        llm = T.AutoModelForCausalLM.from_pretrained({path!r}, device="cpu")
        print(llm("hello", max_new_tokens=3, temperature=0.0))
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ctransformers_tpu"))
        assert not bad, bad
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       env=env, cwd=str(tmp_path), timeout=120)
    assert r.returncode == 0, r.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(tmp_path, no_cuda):
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.AutoModelForCausalLM.from_pretrained(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        T.LLM(path)
    b = load_bundle(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(b.spec, b.params)
    assert Engine(b.spec, b.params, device="cpu").device.type == "cpu"


def test_clearing_logits_drops_the_device_copy(tmp_path):
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path)
    b = load_bundle(path)
    eng = Engine(b.spec, b.params, device="cpu")
    eng.eval([1, 5, 9])
    assert eng.logits is not None and eng._logits_dev is not None
    eng.logits = None
    assert eng.logits is None and eng._logits_dev is None
    eng.eval([4])
    edited = eng.logits
    edited[:] = 0.0  # host edits are what sampling sees
    assert np.all(eng.logits == 0.0)


def test_unserved_arguments_raise(tmp_path):
    path = str(tmp_path / "llama.gguf")
    build_llama_gguf(path)
    llm = T.AutoModelForCausalLM.from_pretrained(path, device="cpu")
    with pytest.raises(NotImplementedError):
        llm.generate([1], grammar="root ::= \"a\"")
    with pytest.raises(NotImplementedError):
        llm.generate([1], guidance_scale=1.5)
    llm.eval([1, 5])
    with pytest.raises(NotImplementedError):
        llm.sample(mirostat=2)
    with pytest.raises(NotImplementedError):
        llm.embed("hello")
    with pytest.raises(NotImplementedError):
        llm.save_session(str(tmp_path / "s.bin"))
    with pytest.raises(NotImplementedError):
        T.AutoModelForCausalLM.from_pretrained(path, device="cpu", lora="x.bin")
    ggjt = str(tmp_path / "llama.bin")  # a file format not yet ported
    build_llama_ggjt(ggjt)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        T.AutoModelForCausalLM.from_pretrained(ggjt, model_type="llama", device="cpu")
