import os

import pytest

# Tests run on the CPU, on a virtual 8-device mesh so sharding semantics are
# exercised without multi-device hardware.  Timings and device behaviour
# come from the GPU: `python chip_smoke.py` on the card, whose last phase
# runs the tests marked `gpu` (EMVS_TEST_GPU=1 keeps the process on the GPU).
_ON_GPU = os.environ.get("EMVS_TEST_GPU") == "1"

if not _ON_GPU:
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips elsewhere; run by "
        "`python chip_smoke.py` on the card)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX runs on no GPU."""
    from dvs_mcemvs_tpu.utils.runtime import on_accelerator

    if not on_accelerator(jax.devices()[0].platform):
        pytest.skip("needs a GPU: run `python chip_smoke.py` on the card")
    return jax.devices()[0]
