"""Test harness config: force JAX onto a virtual 8-device CPU mesh.

Multi-chip hardware is not available in CI; sharding tests run against
``--xla_force_host_platform_device_count=8`` per the build-plan test strategy
(SURVEY.md §7). All platform-forcing logic lives in
m3_tpu.testing.cpu_mesh (shared with __graft_entry__.dryrun_multichip).
"""

from m3_tpu.testing.cpu_mesh import force_cpu_mesh

force_cpu_mesh(8)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (a CUDA kernel has no CPU mode); skips without one"
    )
