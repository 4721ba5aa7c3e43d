"""graftcheck for the port: repo-native static analysis and runtime
invariants over ``dgraph_tpu_torch/`` (``dgraph_tpu/analysis/``'s
counterpart; it imports nothing of that package).

- :mod:`.framework` — AST rule runner, pragma + baseline suppression;
- :mod:`.rules` — the lint rules, scoped to the port's paths;
- :mod:`.lockorder` — static ``with <lock>`` nesting graph over the
  package, cycle detection;
- :mod:`.escape` — static thread-escape pass (``--races``) and its
  sanctioned-shared manifest ``shared.json``, shipped empty;
- :mod:`.witness` — runtime lock-order witness and Eraser lockset
  witness, scoped to ``dgraph_tpu_torch`` modules;
- :mod:`.programs` — the contract registry of the three hand kernels
  (launches a call, output dtypes and shapes, the caller's stream, no
  host sync) and its site coverage.

CLI: ``python -m dgraph_tpu_torch.analysis`` (exits nonzero on any
non-baselined finding or lock-order cycle), ``--races``, and
``--programs [--device cpu]``.
"""

from dgraph_tpu_torch.analysis.framework import (  # noqa: F401
    Finding,
    Rule,
    load_baseline,
    run_rules,
)
from dgraph_tpu_torch.analysis.rules import ALL_RULES  # noqa: F401
