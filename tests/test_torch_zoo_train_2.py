"""Training on the zoo towers without remat, the second half of
``test_torch_zoo.py``'s tower families (``STEP_HALVES``), as
``test_torch_zoo_train.py`` holds the first: one step against JAX's
``make_clip_train_step`` with ``adamw``, fp32 on the CPU
(``torch_zoo_fixtures.check_train_step``). A file of its own so that the
halves run on separate workers."""

import pytest

from torch_zoo_fixtures import (  # noqa: F401 - fixture
    STEP_HALVES,
    check_train_step,
    one_torch_thread,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kind", STEP_HALVES[1])
def test_zoo_train_step_matches_jax(kind):
    check_train_step(kind, remat=False)
