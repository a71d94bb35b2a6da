"""The PyTorch port stands alone: it imports neither JAX nor the JAX
package, keeps config copies equal to the JAX package's, and chip_smoke.py
refuses to run without a card or without the repository."""

import dataclasses
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from clipcap_tpu.core import config as jax_config
from clipcap_tpu_torch.core import config as torch_config

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "clipcap_tpu_torch"
SERVING_MODULES = ["clipcap_tpu_torch.ops.ring", "clipcap_tpu_torch.decode.serving",
                   "clipcap_tpu_torch.cli", "clipcap_tpu_torch.cli.serve",
                   "clipcap_tpu_torch.tools.serving_latency_curve"]
# weights in, captions out: beam, loaders, CLIP scoring, metrics and the CLIs
INFER_MODULES = ["clipcap_tpu_torch.decode.beam", "clipcap_tpu_torch.tokenizers.clip_bpe",
                 "clipcap_tpu_torch.models.clip_text", "clipcap_tpu_torch.eval.clip_scoring",
                 "clipcap_tpu_torch.rank.rankers", "clipcap_tpu_torch.tools.import_weights",
                 "clipcap_tpu_torch.train.checkpoints", "clipcap_tpu_torch.cli.loading",
                 "clipcap_tpu_torch.cli.infer", "clipcap_tpu_torch.eval.scoring",
                 "clipcap_tpu_torch.eval.bleu", "clipcap_tpu_torch.eval.cider",
                 "clipcap_tpu_torch.eval.rouge", "clipcap_tpu_torch.eval.meteor",
                 "clipcap_tpu_torch.eval.synonyms", "clipcap_tpu_torch.eval.spice",
                 "clipcap_tpu_torch.eval.ptb_tokenizer"]
# checkpoint evaluation: the COCO reader, CLIP-guided decode, the validator and its CLI
EVALUATE_MODULES = ["clipcap_tpu_torch.data.coco", "clipcap_tpu_torch.decode.clip_guided",
                    "clipcap_tpu_torch.eval.validator", "clipcap_tpu_torch.cli.evaluate"]
# training: the step, optimizer, AutoClip, loop, shard reader, logger and CLI
TRAIN_MODULES = ["clipcap_tpu_torch.train.autoclip", "clipcap_tpu_torch.train.optim",
                 "clipcap_tpu_torch.train.train_step", "clipcap_tpu_torch.train.trainer",
                 "clipcap_tpu_torch.data.npy_reader", "clipcap_tpu_torch.data.token_prefix",
                 "clipcap_tpu_torch.utils.logging", "clipcap_tpu_torch.cli.train"]

# GPT-J (float, int8, ring) and speculative decoding
GPTJ_MODULES = ["clipcap_tpu_torch.models.gptj", "clipcap_tpu_torch.decode.speculative"]
# T5/T0 (float, int8, ring), its tokenizer and its LM family
T5_MODULES = ["clipcap_tpu_torch.models.t5", "clipcap_tpu_torch.tokenizers.api",
              "clipcap_tpu_torch.lm.registry"]
# dataset preprocessing, the data pipeline, the dataset tools and the tracer
PREPROCESS_MODULES = ["clipcap_tpu_torch.core.dtypes", "clipcap_tpu_torch.data.webdataset",
                      "clipcap_tpu_torch.data.native_jpeg", "clipcap_tpu_torch.data.native_loader",
                      "clipcap_tpu_torch.data.pipeline", "clipcap_tpu_torch.utils.profiling",
                      "clipcap_tpu_torch.tools.preprocess", "clipcap_tpu_torch.tools.merge_shards",
                      "clipcap_tpu_torch.tools.len_distribution",
                      "clipcap_tpu_torch.tools.file_hashes",
                      "clipcap_tpu_torch.tools.resize_images",
                      "clipcap_tpu_torch.tools.profile_decode"]

# Gen B: the BLIP text model, retrieval heads, CLIP ResNet, WordPiece, the
# heterogeneous sampler, the rankers and cascades, synthesis and caption_me
GENB_MODULES = ["clipcap_tpu_torch.models.blip_text", "clipcap_tpu_torch.models.blip_retrieval",
                "clipcap_tpu_torch.models.clip_resnet", "clipcap_tpu_torch.tokenizers.wordpiece",
                "clipcap_tpu_torch.decode.hetero", "clipcap_tpu_torch.rank.cascade",
                "clipcap_tpu_torch.cli.synthesis", "clipcap_tpu_torch.cli.caption_me"]
# the rest of Gen B: TPE, the COCO sampling sweep, human-eval preparation and
# Gumbel caption optimization
GENB_REST_MODULES = ["clipcap_tpu_torch.utils.tpe", "clipcap_tpu_torch.cli.sweep",
                     "clipcap_tpu_torch.cli.human_eval",
                     "clipcap_tpu_torch.tools.gumbel_caption_opt"]

# parallelism: the mesh, the six parallel modules, the MoE mapper and the drive
PARALLEL_MODULES = ["clipcap_tpu_torch.core.mesh", "clipcap_tpu_torch.parallel",
                    "clipcap_tpu_torch.parallel.sharding", "clipcap_tpu_torch.parallel.dp",
                    "clipcap_tpu_torch.parallel.tp", "clipcap_tpu_torch.parallel.pp",
                    "clipcap_tpu_torch.parallel.sp", "clipcap_tpu_torch.parallel.ep",
                    "clipcap_tpu_torch.models.moe", "clipcap_tpu_torch.tools.dryrun_multichip"]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import clipcap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(clipcap_tpu_torch.__path__, "clipcap_tpu_torch.")]
for name in names:
    importlib.import_module(name)
print("WALKED", sorted(names))
bad = sorted(n for n in sys.modules
             if n in ("jax", "jaxlib", "triton", "clipcap_tpu") or n.startswith(("jax.", "clipcap_tpu.")))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_pulls_in_no_jax_triton_or_jax_package():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], capture_output=True, text=True,
                         cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    # the walk reaches the serving slice's modules too
    for name in SERVING_MODULES:
        assert f"'{name}'" in out.stdout, name


# every module imports with jax, PIL, regex, tokenizers and transformers
# unimportable: the port imports PIL, regex and tokenizers inside the
# functions that need them, and transformers never
_IMPORT_ALL_BLOCKED = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "PIL", "regex", "tokenizers", "transformers", "clipcap_tpu")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
""" + _IMPORT_ALL


def test_every_module_imports_without_jax_pil_regex_or_transformers():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL_BLOCKED], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    for name in (SERVING_MODULES + INFER_MODULES + EVALUATE_MODULES + TRAIN_MODULES
                 + GPTJ_MODULES + T5_MODULES + PREPROCESS_MODULES + GENB_MODULES
                 + GENB_REST_MODULES + PARALLEL_MODULES):
        assert f"'{name}'" in out.stdout, name


# int8 decode: ops/quant, GPT-2's int8 module and caches, the int8 ViT, the
# bundle's switch and the paths that carry the int8 cache
INT8_MODULES = {"clipcap_tpu_torch.ops.quant": ["Int8Linear", "int8_linear", "quantize_rows",
                                                "quantize_weight", "int_mm"],
                "clipcap_tpu_torch.models.gpt2": ["GPT2Int8", "Int8KVCache", "Int8BeamCache",
                                                  "quantize_params"],
                "clipcap_tpu_torch.models.gptj": ["GPTJInt8", "quantize_params"],
                "clipcap_tpu_torch.models.t5": ["T5Int8", "quantize_params"],
                "clipcap_tpu_torch.models.vit": ["quantize_params"],
                "clipcap_tpu_torch.models.bundle": ["CaptionerBundle"],
                "clipcap_tpu_torch.decode.beam": ["beam_search_batched"],
                "clipcap_tpu_torch.decode.clip_guided": ["generate_clip_guided_batch"]}

_IMPORT_INT8 = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "triton", "clipcap_tpu"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import importlib, torch
for name, attrs in %r.items():
    module = importlib.import_module(name)
    assert all(hasattr(module, a) for a in attrs), name
assert hasattr(importlib.import_module("clipcap_tpu_torch.models.bundle").CaptionerBundle,
               "enable_int8_decode")
print("CUDA", torch.cuda.is_available())
print("INT8 OK")
""" % (INT8_MODULES,)


def test_int8_modules_import_without_jax_or_cuda():
    out = subprocess.run([sys.executable, "-c", _IMPORT_INT8], capture_output=True, text=True,
                         cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "INT8 OK" in out.stdout and "CUDA False" in out.stdout, out.stdout


# the preprocessing modules import without jax, triton, PIL or matplotlib,
# without starting CUDA, and without building or loading a native library
_IMPORT_PREPROCESS = """
import ctypes, importlib.abc, subprocess, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "triton", "clipcap_tpu", "PIL", "matplotlib"):
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import importlib, numpy, torch
def refuse(*a, **k):
    raise AssertionError(f"import ran {a[:1]}")
subprocess.run = subprocess.Popen = ctypes.CDLL = refuse
for name in %r:
    importlib.import_module(name)
from clipcap_tpu_torch.data import native_jpeg, native_loader
assert native_jpeg._lib is None and native_loader._lib is None
print("CUDA initialized", torch.cuda.is_initialized())
print("PREPROCESS OK")
""" % (PREPROCESS_MODULES,)


def test_preprocess_modules_import_without_pil_cuda_or_a_native_build():
    out = subprocess.run([sys.executable, "-c", _IMPORT_PREPROCESS], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "PREPROCESS OK" in out.stdout and "CUDA initialized False" in out.stdout, out.stdout


# the rest of Gen B imports without jax, triton, PIL, matplotlib, yaml or wandb
# (each is imported inside the function that needs it) and without CUDA
_IMPORT_GENB_REST = """
import importlib.abc, sys
BLOCKED = ("jax", "jaxlib", "triton", "clipcap_tpu", "PIL", "matplotlib", "yaml", "wandb")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked: {name}")
        return None
sys.meta_path.insert(0, Block())
import importlib, torch
for name in %r:
    importlib.import_module(name)
from clipcap_tpu_torch.models.blip_text import serving_decoder_lm
print("CUDA initialized", torch.cuda.is_initialized())
print("GENB REST OK")
""" % (GENB_REST_MODULES,)


def test_genb_rest_modules_import_without_jax_plots_yaml_or_cuda():
    out = subprocess.run([sys.executable, "-c", _IMPORT_GENB_REST], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode == 0, out.stderr
    assert "GENB REST OK" in out.stdout and "CUDA initialized False" in out.stdout, out.stdout


def test_source_has_no_jax_or_jax_package_import():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|clipcap_tpu)(\.|\s|$)", re.M)
    top = re.compile(r"^(import|from)\s+(PIL|regex|tokenizers|transformers)(\.|\s|$)", re.M)
    hits = []
    paths = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for name in (SERVING_MODULES + INFER_MODULES + EVALUATE_MODULES + TRAIN_MODULES
                 + GPTJ_MODULES + T5_MODULES + PREPROCESS_MODULES + GENB_MODULES
                 + GENB_REST_MODULES + PARALLEL_MODULES):
        rel = Path(*name.split("."))
        assert ROOT / rel.with_suffix(".py") in paths or ROOT / rel / "__init__.py" in paths
    for path in paths:
        text = path.read_text()
        for m in pat.finditer(text):
            hits.append(f"{path.relative_to(ROOT)}: {m.group(0).strip()}")
        # PIL, regex and tokenizers only inside functions; transformers nowhere
        for m in top.finditer(text):
            hits.append(f"{path.relative_to(ROOT)} at module level: {m.group(0).strip()}")
        if re.search(r"^\s*(import|from)\s+transformers", text, re.M):
            hits.append(f"{path.relative_to(ROOT)}: imports transformers")
    assert hits == []


@pytest.mark.parametrize("name", ["MapperConfig", "GPT2Config", "GPTJConfig", "T5Config",
                                  "ViTConfig", "BlipTextConfig",
                                  "CaptionerConfig", "CLIPTextConfig", "TrainConfig"])
def test_config_fields_and_defaults_match_jax(name):
    a, b = getattr(jax_config, name), getattr(torch_config, name)
    fa = [(f.name, f.type) for f in dataclasses.fields(a)]
    fb = [(f.name, f.type) for f in dataclasses.fields(b)]
    assert fa == fb
    assert dataclasses.asdict(a()) == dataclasses.asdict(b())
    assert a().to_json() == b().to_json()


@pytest.mark.parametrize("name", ["DTypePolicy", "FP32", "BF16_INFERENCE", "default_policy"])
def test_dtype_policy_fields_and_defaults_match_jax(name):
    """core/dtypes: the same fields, and the same dtypes by name, over torch
    dtypes where the JAX package has jnp ones."""
    import jax.numpy as jnp
    import torch

    from clipcap_tpu.core import dtypes as jax_dtypes
    from clipcap_tpu_torch.core import dtypes as torch_dtypes

    def policy(mod):
        obj = getattr(mod, name)
        return obj() if callable(obj) else obj

    a, b = policy(jax_dtypes), policy(torch_dtypes)
    fields = [f.name for f in dataclasses.fields(jax_dtypes.DTypePolicy)]
    assert fields == [f.name for f in dataclasses.fields(torch_dtypes.DTypePolicy)]
    assert ([jnp.dtype(getattr(a, f)).name for f in fields]
            == [str(getattr(b, f)).removeprefix("torch.") for f in fields])
    x = torch.ones(2, dtype=torch.float16)
    assert b.cast_compute(x).dtype == b.compute_dtype and b.cast_accum(x).dtype == b.accum_dtype
    y = torch.ones(2, dtype=b.compute_dtype)
    assert b.cast_compute(y) is y


@pytest.mark.parametrize("variant", ["gpt2", "gpt2-medium", "gpt2-large", "gpt2-xl"])
def test_gpt2_variants_match_jax(variant):
    assert (dataclasses.asdict(jax_config.GPT2Config.variant(variant))
            == dataclasses.asdict(torch_config.GPT2Config.variant(variant)))


@pytest.mark.parametrize("variant", ["EleutherAI/gpt-j-6B", "gpt-j-6B", "gptj"])
def test_gptj_variants_match_jax(variant):
    assert (dataclasses.asdict(jax_config.GPTJConfig.variant(variant))
            == dataclasses.asdict(torch_config.GPTJConfig.variant(variant)))


@pytest.mark.parametrize("variant", ["t5-small", "t5-base", "t5-large", "t0-11b"])
def test_t5_variants_match_jax(variant):
    assert (dataclasses.asdict(jax_config.T5Config.variant(variant))
            == dataclasses.asdict(torch_config.T5Config.variant(variant)))


@pytest.mark.parametrize("variant", ["ViT-B/32", "ViT-B/16", "ViT-L/14", "ViT-L/14@336px"])
def test_vit_variants_match_jax(variant):
    a = jax_config.ViTConfig.clip_variant(variant)
    b = torch_config.ViTConfig.clip_variant(variant)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert (a.grid, a.seq_len) == (b.grid, b.seq_len)
    for name in ("ViT-B", "ViT-L"):
        assert (dataclasses.asdict(jax_config.ViTConfig.blip_variant(name))
                == dataclasses.asdict(torch_config.ViTConfig.blip_variant(name)))


def test_chip_smoke_fails_without_a_card():
    """On a machine without CUDA the smoke exits non-zero and prints no result."""
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, cwd=ROOT, env=_env(), timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no CUDA device" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the smoke exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no clipcap_tpu_torch package" in out.stderr
