"""The PyTorch port stands alone: importing every ``repro_torch`` module and
``chip_smoke.py`` loads no ``jax``, no ``jaxlib`` and nothing of ``repro``,
and needs neither ``triton`` nor ``nvcc`` (both are used only on a card, at
first launch)."""
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, importlib.abc, json, pkgutil, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "triton" or name.startswith("triton."):
            raise ImportError("triton is blocked in this probe")
        return None

sys.meta_path.insert(0, _Block())
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "forbidden": bad}))
"""


def test_port_imports_no_jax_no_repro():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # no CUDA toolkit on the path: importing must not need nvcc
    env["PATH"] = os.pathsep.join(
        p for p in env.get("PATH", "").split(os.pathsep)
        if not (Path(p) / "nvcc").exists())
    env.pop("CUDA_HOME", None)
    out = subprocess.run([sys.executable, "-c", PROBE,
                          str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["forbidden"] == [], res["forbidden"]
    expected = {"repro_torch.core.engine", "repro_torch.core.search",
                "repro_torch.core.graph", "repro_torch.core.pq",
                "repro_torch.core.records", "repro_torch.core.selectors",
                "repro_torch.core.prefilter", "repro_torch.core.cost_model",
                "repro_torch.core.labels", "repro_torch.core.ranges",
                "repro_torch.core.bloom", "repro_torch.core.io_sim",
                "repro_torch.data.synth", "repro_torch.kernels.ref",
                "repro_torch.kernels.ops", "repro_torch.kernels.build",
                "repro_torch.api", "repro_torch.api.filters",
                "repro_torch.api.index", "repro_torch.api.schema",
                "repro_torch.api.session", "repro_torch.api.types",
                "repro_torch.serve", "repro_torch.serve.server",
                "repro_torch.serve.retrieval", "repro_torch.ckpt",
                "repro_torch.ckpt.checkpoint", "repro_torch.core.faults",
                "repro_torch.core.distributed", "repro_torch.models",
                "repro_torch.models.common", "repro_torch.models.attention",
                "repro_torch.models.mlp", "repro_torch.models.moe",
                "repro_torch.models.ssm", "repro_torch.models.blocks",
                "repro_torch.models.lm", "repro_torch.models.convert",
                "repro_torch.configs", "repro_torch.configs.registry",
                "repro_torch.serve.decode", "repro_torch.launch",
                "repro_torch.launch.serve", "repro_torch.random",
                "repro_torch.utils", "repro_torch.utils.tree",
                "repro_torch.utils.trace",
                "repro_torch.data.tokens", "repro_torch.data.pipeline",
                "repro_torch.train", "repro_torch.train.optim",
                "repro_torch.train.train_loop",
                "repro_torch.train.grad_compress",
                "repro_torch.launch.train", "repro_torch.launch.mesh",
                "repro_torch.launch.shardings", "repro_torch.launch.roofline",
                "repro_torch.launch.dryrun", "repro_torch.launch.dryrun_ann",
                "repro_torch.launch.roofline_table",
                "repro_torch.serve.sp_attention"}
    assert expected <= set(res["modules"]), expected - set(res["modules"])


def test_port_sources_never_name_jax():
    """No module of the port imports jax or repro, even lazily."""
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "repro"), \
                    f"{path}: {s}"
