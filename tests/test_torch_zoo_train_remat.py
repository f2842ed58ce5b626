"""Training on the zoo towers with remat, the first half of
``test_torch_zoo.py``'s tower families (``STEP_HALVES``; the other half in
``test_torch_zoo_train_remat_2.py``): one step with each block under
``torch.utils.checkpoint`` against JAX's ``make_clip_train_step`` with
``adamw`` and ``remat=True`` (``nn.remat`` per block; a Transformer policy
for EVA01), fp32 on the CPU, within the tolerances of
``test_torch_zoo_train.py``
(``torch_zoo_fixtures.check_train_step``). Files of their own so that the
halves run on separate workers."""

import pytest

from torch_zoo_fixtures import (  # noqa: F401 - fixture
    STEP_HALVES,
    check_train_step,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kind", STEP_HALVES[0])
def test_zoo_remat_train_step_matches_jax(kind):
    check_train_step(kind, remat=True)
