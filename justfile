# kaptive-tpu project justfile
# Run `just` to see all available commands (capability parity with the
# reference's justfile; recipes re-expressed for this repo's layout).

set shell := ["bash", "-uc"]

# Show available commands
default:
    @just --list

# Remove caches and build artifacts
clean:
    rm -rf build dist site .ruff_cache .pytest_cache
    find . -type d -name "__pycache__" -exec rm -rf {} +
    find . -type f -name "*.pyc" -delete

# Editable install (no build isolation; deps are expected preinstalled)
install:
    pip install -e . --no-deps --no-build-isolation

# Run the kaptive-tpu CLI (e.g. `just run db list`)
run *args:
    python -m kaptive_tpu.cli {{args}}

# Full test suite on the CPU backend with a virtual 8-device mesh
test *args:
    JAX_PLATFORMS=cpu python -m pytest tests/ -q {{args}}

# GPU-only tests (the CUDA SWG kernel against lax and the numpy oracle)
test-gpu:
    python -m pytest tests/ -q -m gpu

# End-to-end proof on one GPU: kernel parity, typing, seed-mode parity
smoke *args:
    python chip_smoke.py {{args}}

# Lint + format check (same gate as CI)
lint:
    ruff check kaptive_tpu tests scripts bench.py
    ruff format --check kaptive_tpu

# Apply formatting
format:
    ruff format kaptive_tpu

# Throughput benchmark on the GPU (prints one JSON line)
bench *args:
    python bench.py {{args}}

# Regenerate the API and CLI reference pages under docs/
docs:
    python scripts/generate_api_docs.py
    NO_COLOR=1 python scripts/generate_cli_docs.py

# Build the container image
docker:
    docker build -t kaptive-tpu .

# Build the Apptainer/Singularity image
apptainer:
    apptainer build kaptive-tpu.sif Apptainer.def
