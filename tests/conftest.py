# Tests run on the single host CPU device (the dry-run, and ONLY the
# dry-run, forces 512 placeholder devices via XLA_FLAGS in its own
# process).  Keep jax state untouched here.
import jax

jax.config.update("jax_platform_name", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips (inside a fixture) "
        "where there is none")
