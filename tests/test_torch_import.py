"""The port stands alone: it imports neither JAX nor the JAX package."""

import pathlib
import re
import subprocess
import sys
import textwrap

ROOT = pathlib.Path(__file__).resolve().parents[1]
IMPORT = re.compile(r"^\s*(?:from|import)\s+(jax|repro)\b", re.MULTILINE)


def test_persistence_imports_with_jax_and_repro_blocked():
    code = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        import repro_torch.persistence
        import repro_torch.kernels
        import repro_torch.kernels.build
        import repro_torch.kernels.delta_pack
        import repro_torch.kernels.flush_scan
        from repro_torch.kernels import apply_delta, flush_scan, pack_delta, pack_dirty
        import repro_torch.models
        import repro_torch.configs
        import repro_torch.optim
        import repro_torch.data
        import repro_torch.launch.steps
        import repro_torch.launch.train
        import repro_torch.launch.serve
        import repro_torch.persistence.flusher
        import repro_torch.core.recovery
        import repro_torch.io.engine
        import repro_torch.cluster
        import repro_torch.serve
        from repro_torch.core import KVConfig, PersistentKV
        from repro_torch.io import IOEngine
        from repro_torch.cluster import ClusterKV
        from repro_torch.serve import ModelStateStore, ServeFrontend
        from repro_torch.configs import get_config
        from repro_torch.models import init_params
        import repro_torch.models.ssd
        init_params(get_config("tinyllama-1.1b"), device="meta")
        init_params(get_config("mamba2-130m"), device="meta")
        init_params(get_config("whisper-large-v3"), device="meta")
        loaded = [m for m, mod in sys.modules.items() if mod is not None
                  and (m == "jax" or m.startswith(("jax.", "repro.")))]
        assert not loaded, loaded
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_source_of_the_port_imports_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = {str(f.relative_to(ROOT)): IMPORT.findall(f.read_text())
                 for f in files}
    assert {f: m for f, m in offenders.items() if m} == {}
