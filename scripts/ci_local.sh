#!/bin/sh
# One-command local CI: the same checks .github/workflows/tests.yml runs,
# degrading gracefully when optional tooling (ruff, mkdocs) is absent in
# the local image.
set -e
cd "$(dirname "$0")/.."

echo "== byte-compile (syntax gate) =="
python -m compileall -q tabcorr_tpu scripts tests bench.py __graft_entry__.py

if command -v ruff > /dev/null 2>&1; then
    echo "== ruff =="
    ruff check tabcorr_tpu/ scripts/ tests/ bench.py __graft_entry__.py
else
    echo "== ruff not installed; skipped (CI runs it) =="
fi

if command -v mkdocs > /dev/null 2>&1; then
    echo "== docs build =="
    mkdocs build --strict
else
    echo "== mkdocs not installed; skipped (CI runs it) =="
fi

echo "== fast test suite =="
python -m pytest tests/ -m "not slow" -q

echo "== slow suite (goldens + pipeline; fast on CPU via the native counter) =="
python -m pytest tests/ -m slow -q

echo "== example smoke (wp / ds / fisher / nonparametric) =="
# Pin the CPU backend via jax.config, which holds even where JAX was
# imported before the environment was read.
for ex in example_wp example_ds example_fisher example_nonparametric; do
    MPLBACKEND=Agg python -c "
import jax
jax.config.update('jax_platforms', 'cpu')
import runpy
runpy.run_path('examples/$ex.py', run_name='__main__')
" > /dev/null
done
echo "LOCAL CI GREEN"
