# kaptive-tpu container image.
#
# Mirrors the reference's container story (/root/reference/Dockerfile) with a
# plain pip build: the package has two runtime dependencies (numpy, jax with
# its CUDA plugin), a C++ toolchain for the native host-ingest path, and the
# CUDA toolkit's nvcc for the banded-SWG kernel (built at first use on a GPU).

FROM nvidia/cuda:12.8.0-devel-ubuntu24.04 AS base

WORKDIR /app

ENV PYTHONDONTWRITEBYTECODE=0 \
    PIP_NO_CACHE_DIR=1

# g++ enables the native hostio ingest library (built lazily at first import;
# everything still works without it, just with slower host-side FASTA ingest).
RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ python3 python3-pip python3-venv \
    && rm -rf /var/lib/apt/lists/* \
    && python3 -m venv /opt/venv
ENV PATH=/opt/venv/bin:$PATH

# Dependency layer first so source edits do not bust the cache.
COPY pyproject.toml README.md ./
RUN pip install numpy "jax[cuda12]~=0.9.0"

COPY kaptive_tpu ./kaptive_tpu
COPY native ./native
RUN pip install --no-deps .

# Warm the native library build so first container run does not pay it.
RUN python -c "import kaptive_tpu.native" || true

ENTRYPOINT ["kaptive-tpu"]
CMD ["--help"]
