"""The kernels pass of ``repro_torch.analysis`` on the card (marked
``cuda``; skips where there is none): every instantiation of the four
built CUDA sources within an H100 block's registers, register file and
shared memory, no spill but the known ones, and every launch case of
the op wrappers launching its own kernel at the caller's shape (the
lane-odd head dim refused as documented).

    python -m pytest -m cuda tests/test_torch_kernels_check.py
"""
import pytest

torch = pytest.importorskip("torch")
# the xdist workers share the host's cores: one intra-op thread each (at
# torch's default of one a core they oversubscribe them)
torch.set_num_threads(1)

from repro_torch.analysis import kernels_check  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels are CUDA C++)")
    return torch.device("cuda", 0)


def test_kernels_pass_is_clean_over_the_built_libraries(dev):
    findings, n = kernels_check.check_all()
    assert findings == [], "\n".join(f.format() for f in findings)
    sources = {i.source for i in kernels_check.resources()}
    assert sources == set(kernels_check.SOURCES)
    assert n >= len(kernels_check.cases()) + 100
