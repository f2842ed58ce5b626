"""The zoo towers' flax trees and bundles against the JAX package on the
CPU, the first half of ``torch_export_fixtures.KINDS`` (the other is in
``tests/test_torch_export_zoo_2.py``): (a) the port's
``jax_params_from_clip`` equals JAX's converter bit for bit, (b) a
port-written bundle loads in JAX within 1e-5, (c) a JAX-written bundle
loads in the port bit-equal."""

import pytest

from torch_export_fixtures import (
    HALVES,
    check_jax_bundle_in_port,
    check_port_bundle_in_jax,
    check_writer,
)
from torch_zoo_fixtures import one_torch_thread  # noqa: F401 - fixture

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("kind", HALVES[0])
def test_writer_equals_jax_converter(kind):
    check_writer(kind)


@pytest.mark.parametrize("kind", HALVES[0])
def test_port_bundle_loads_in_jax(kind, tmp_path):
    check_port_bundle_in_jax(kind, str(tmp_path / "bundle"))


@pytest.mark.parametrize("kind", HALVES[0])
def test_jax_bundle_loads_in_port(kind, tmp_path):
    check_jax_bundle_in_port(kind, tmp_path)
