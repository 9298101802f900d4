import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

_SAN = os.environ.get("REPRO_SANITIZE", "").lower() not in ("", "0", "false")


@pytest.fixture(autouse=_SAN)
def _ocrsan_gate():
    """With REPRO_SANITIZE set, every Runtime in the suite records (and in
    strict mode raises on) sanitizer findings.  This gate additionally
    fails any test that *recorded* a hard finding but never surfaced it —
    e.g. a runtime that never reached ``run()`` return, or a swallowed
    strict error.  Tests that intentionally seed bugs consume their
    findings via ``san_report()`` / the raised ``OcrSanError``."""
    yield
    from repro.analysis import active_sanitizers

    leaked = []
    for san in active_sanitizers():
        found = san.unconsumed_hard()
        if found:
            leaked.extend(found)
            san.consume()
    assert not leaked, "unreported sanitizer findings:\n" + \
        "\n".join(str(f) for f in leaked)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch sees none")
