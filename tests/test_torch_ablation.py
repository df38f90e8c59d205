"""The ablation tool's variants stay in step with the kernel sources: each
variant of K1, K4 and K2 (`python -m zllm_torch.k1_ablation --kernel ...`)
finds its anchor text in the current source exactly once, so none is
reported as missing from this form, and each changes the source."""

import pytest

from zllm_torch import k1_ablation as ab
from zllm_torch.ops import cuda


@pytest.mark.parametrize("kernel", sorted(ab.KERNELS))
def test_every_ablation_variant_applies(kernel):
    kern = ab.KERNELS[kernel]
    for name in kern.variants:
        texts = ab.variant_sources(kern, name)
        assert texts is not None, f"{kernel} {name}: no alternative fits the sources"
        assert any(t != (cuda.CSRC / f).read_text() for f, t in texts.items()), name
