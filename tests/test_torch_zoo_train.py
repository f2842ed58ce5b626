"""Training on the zoo towers: one step of each tower family of
``test_torch_zoo.py`` (each inside a CLIP with a one-layer text tower), the
port against JAX's ``make_clip_train_step`` with ``adamw``, fp32 on the
CPU, without remat, for the first half of the families (``STEP_HALVES``;
the second in ``test_torch_zoo_train_2.py``, both halves with remat in
``test_torch_zoo_train_remat{,_2}.py``): the loss within 1e-5, the
gradients within 1e-4 of JAX's relative to its largest |gradient|, the
updated weights within 1e-5
(``torch_zoo_fixtures.check_train_step``). The port's tensors reach JAX's
tree through JAX's converter (the port's folded FastViT through
``torch_zoo_fixtures.fastvit_flax_visual``). The freeze labels, the
weight-decay mask, bf16 compute and the ModifiedResNet statistics are in
``test_torch_zoo_train_labels.py``; each file runs on a worker of its
own."""

import pytest

from torch_zoo_fixtures import (  # noqa: F401 - fixture
    STEP_HALVES,
    check_train_step,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kind", STEP_HALVES[0])
def test_zoo_train_step_matches_jax(kind):
    check_train_step(kind, remat=False)
