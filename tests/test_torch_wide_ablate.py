"""The wide forms' ablation tool (demo2_tpu_torch/tools/wide_ablate.py): each
ablation's text substitutions apply to its kernel source as it stands
(csrc/packed_attention_wide.cu for the wide pair, csrc/attention_wide_block.cuh
for the block kernels' wide forms), so a change to a kernel that moves the
text an ablation edits fails here rather than on the card."""

import pytest

from demo2_tpu_torch.tools import wide_ablate


@pytest.mark.parametrize("name", sorted(wide_ablate.ABLATIONS))
def test_every_ablation_applies_to_the_kernel_source(name):
    source = wide_ablate.SOURCE.read_text()
    changed = wide_ablate.ablated(source, name)
    assert changed != source
    for old, new in wide_ablate.ABLATIONS[name]:
        assert new in changed


@pytest.mark.parametrize("name", sorted(wide_ablate.BLOCK_ABLATIONS))
def test_every_block_ablation_applies_to_the_block_source(name):
    source = wide_ablate.BLOCK_SOURCE.read_text()
    changed = wide_ablate.ablated(source, name, wide_ablate.BLOCK_ABLATIONS)
    assert changed != source
    for old, new in wide_ablate.BLOCK_ABLATIONS[name]:
        assert new in changed


def test_a_missing_piece_of_text_is_refused():
    with pytest.raises(ValueError, match="not found exactly once"):
        wide_ablate.ablated("no kernel here", "fwd_noexp")
