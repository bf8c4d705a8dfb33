"""The port's static analysis, contracts and device audits.

Counterpart: reporter_tpu/analysis/ (imports nothing of it):

  lint_rules.py          AST lints over reporter_tpu_torch/ and
                         chip_smoke.py: env truthiness through the one
                         parser, the README's port env table and metric
                         inventory, no blocking call under a lock, no
                         forked wire body, staged-table completeness, no
                         dead import or private.
  concurrency_contract   the committed lockdep state: the legal lock-order
                         edges and the blocking-call allowlist, extended
                         with dated justifications only. The runtime half
                         is utils/locks.py, armed by tests/_torch_support.py.
  global_state           the process globals the tests' leak gate holds.
  slo_contract           the committed SLO specs' validator.
  device_contract        the aten-level audit of every wire entry x arm x
                         layout x path, and the scatters.
  compile_manifest       the CUDA sweep's instances, launch shapes and
                         ptxas budgets, and the HBM bound.
  bench_delta            the regression sentinel over two chip_smoke.py
                         logs (``python -m reporter_tpu_torch.analysis.
                         bench_delta old.log new.log``) and the lint's
                         bench-coverage rule.

``python -m reporter_tpu_torch.analysis`` runs them (``--help``).
"""

from reporter_tpu_torch.analysis.lint_rules import Finding, run_lint

__all__ = ["Finding", "run_lint"]
