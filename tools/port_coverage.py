"""What the PyTorch port still lacks, counted on the CPU with both
packages imported: the op lowerings each registers, and the names of
``API.spec`` that do not resolve with ``paddle_tpu.`` replaced by
``paddle_tpu_torch.``, grouped by their first component.

    JAX_PLATFORMS=cpu python tools/port_coverage.py
"""
from __future__ import annotations

import collections
import importlib
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def spec_names(path):
    names = []
    for line in open(path):
        m = re.match(r"(paddle_tpu(?:\.\w+)+)", line)
        if m and m.group(1) not in names:
            names.append(m.group(1))
    return names


def resolves(name):
    parts = name.split(".")
    parts[0] = "paddle_tpu_torch"
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ImportError:
            continue
        try:
            for p in parts[i:]:
                obj = getattr(obj, p)
        except AttributeError:
            return False
        return True
    return False


def main():
    import paddle_tpu.framework.lowering as jl
    import paddle_tpu_torch.framework.lowering as tl

    jax_ops, port_ops = set(jl.LOWERINGS), set(tl.LOWERINGS)
    names = spec_names(os.path.join(ROOT, "API.spec"))
    missing = [n for n in names if not resolves(n)]
    groups = collections.Counter(n.split(".")[1] for n in missing)
    print(json.dumps({
        "lowerings_port": len(port_ops),
        "lowerings_port_of_jax": len(port_ops & jax_ops),
        "lowerings_port_only": sorted(port_ops - jax_ops),
        "lowerings_missing": len(jax_ops - port_ops),
        "api_spec_names": len(names),
        "api_spec_unresolved": len(missing),
        "api_spec_unresolved_by_group": dict(groups.most_common()),
    }, indent=1))


if __name__ == "__main__":
    main()
