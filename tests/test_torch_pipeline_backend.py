"""Comparator.fetch_compare_pure, the side-effect-free fetch that
fetch_compare is built on, on the CPU, one torch thread: it changes
nothing on the comparator, and fetch_compare then applies the same
distance and distmap.
"""

import numpy as np

from tests.conftest import FIXTURES
from tests.torch_threads import one_torch_thread  # noqa: F401

from guetzli_tpu_torch import comparator as cmp_mod


def test_fetch_compare_pure_has_no_side_effects():
    from guetzli_tpu_torch.codec.encoder import encode_rgb_to_jpeg
    from guetzli_tpu_torch.io.png import read_png
    from guetzli_tpu_torch.search import state as st
    rgb, w, h = read_png((FIXTURES / "bees96x64.png").read_bytes())
    jpg = encode_rgb_to_jpeg(rgb, w, h)
    st.remove_original_quantization(jpg)
    img = st.CoeffImage.from_jpeg(jpg)
    comp = cmp_mod.Comparator(rgb, w, h, 1.0, "cpu")
    handle = comp.dispatch_compare_with_weights(img, 1, 1.0, 1, 1)
    d, w4, dmap = comp.fetch_compare_pure(handle)
    assert comp.distance == 0.0 and comp.distmap is None
    assert (d, dmap) == (float(handle[0]), handle[1])
    np.testing.assert_array_equal(w4, handle[2].numpy())
    assert comp.fetch_compare(handle)[0] == d and comp.distmap is dmap
