"""The port's OBJ loaders (the native one and the Python one) against the
JAX package's, bit for bit."""

import numpy as np
import pytest
import torch

from zeldaengine_tpu.scene.mesh import load_obj as j_load_obj
from zeldaengine_tpu_torch.scene.mesh import load_obj

from _torch_meshlet_inputs import _obj_text, _BARE

torch.set_num_threads(1)


@pytest.mark.parametrize("text", ["grid-quads", "grid-triangles", "bare"])
def test_load_obj_native_equals_python_and_the_reference(tmp_path, text):
    path = str(tmp_path / "m.obj")
    with open(path, "w") as f:
        f.write({"grid-quads": _obj_text(True),
                 "grid-triangles": _obj_text(False), "bare": _BARE}[text])
    got = load_obj(path)
    plain = load_obj(path, backend="python")
    want = j_load_obj(path)
    assert got.num_triangles == {"bare": 3}.get(text, 24)
    for name in ("positions", "normals", "uvs", "colors", "indices"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(plain, name), err_msg=name)
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    with pytest.raises(OSError):
        load_obj(str(tmp_path / "missing.obj"))
    with pytest.raises(ValueError, match="backend"):
        load_obj(path, backend="fast")
