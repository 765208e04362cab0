"""PIFE over every TRANSFORMER_TYPE of the JAX package's T2T_CONFIGS,
RESNET_CONFIGS and OSNET_CONFIGS against JAX's PIFE on the CPU (T2T at one
block of its width, the CNN trunks whole), and the types both refuse.
Every flax leaf is a seeded random value loaded into the port through the
converter; inputs are seeded numpy arrays; images are 64x32.  The modules
themselves: tests/test_torch_backbones.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from demo2_tpu.models import osnet as josnet, resnet as jresnet, t2t as jt2t
from demo2_tpu.models.pife import PIFE as JPIFE
from demo2_tpu_torch.models.pife import PIFE
from torch_port_helpers import (CPU, apply_jit, as_close_as_jax, as_f64, close_to_scale,
                                generator, load_port, n, random_variables, t)

F32 = torch.float32
CAMS, VIEWS = 3, 2


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's side on one thread: the suite runs several workers, each
    with its own pool, and spinning pools oversubscribe the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

ALL_TYPES = (sorted(jt2t.T2T_CONFIGS) + sorted(jresnet.RESNET_CONFIGS)
             + sorted(josnet.OSNET_CONFIGS))


@pytest.mark.parametrize("tt", ALL_TYPES)
def test_pife_other_backbones_match_jax(tt):
    """PIFE builds each type as JAX does (T2T at one block of its width,
    the CNN trunks whole), with its feat_dim, and gives JAX's patches and
    globals in eval, a modality masked.  The masked modality's zero images
    reach the IBN InstanceNorms as near-constant maps, whose variance of ~0
    magnifies f32 noise by up to rsqrt(1e-5): the CNN types are held as
    as_close_as_jax holds them, against an f64 run of the port."""
    kw = dict(transformer_type=tt, img_size=(64, 32), stride_size=(16, 16), camera_num=CAMS,
              view_num=VIEWS, sie_camera=True, sie_view=True, sie_coe=1.5, drop_path=0.1,
              depth_override=1 if tt.startswith("t2t") else -1, width_override=-1,
              heads_override=-1)
    jm = JPIFE(attn_implementation="pallas", **kw)
    rng = np.random.default_rng(6)
    images = rng.standard_normal((2, 3, 64, 32, 3)).astype(np.float32)
    cams, views = rng.integers(0, CAMS, 2), rng.integers(0, VIEWS, 2)
    mask = np.asarray([1.0, 0.0, 1.0], np.float32)
    variables = random_variables(jm, images, cams, views, mask, seed=6)
    port = load_port(PIFE(fused=True, dtype=F32, device=CPU, generator=generator(), **kw),
                     variables)
    assert port.feat_dim == jm.feat_dim
    args = tuple(map(jnp.asarray, (images, cams, views, mask)))
    want_p, want_g = apply_jit(jm, variables, *args)
    with torch.no_grad():
        got_p, got_g = port(t(images), t(cams).long(), t(views).long(), t(mask))
    assert got_g.shape == (3, 2, jm.feat_dim) and got_p.shape == (3, 2, 8, jm.feat_dim)
    if tt.startswith("t2t"):
        close_to_scale(got_p, want_p)
        close_to_scale(got_g, want_g)
        return
    with torch.no_grad():
        ref_p, ref_g = as_f64(port)(t(images).double(), t(cams).long(), t(views).long(), t(mask))
    as_close_as_jax(got_p, want_p, n(ref_p))
    as_close_as_jax(got_g, want_g, n(ref_g))


@pytest.mark.parametrize("tt,match", [("resnet18", "Bottleneck variants"),
                                      ("resnet34", "Bottleneck variants"),
                                      ("osnet_x0_75", "ported widths")])
def test_pife_refuses_what_jax_refuses(tt, match):
    kw = dict(transformer_type=tt, img_size=(64, 32), stride_size=(16, 16), camera_num=0,
              sie_camera=False, sie_coe=1.0, depth_override=-1, width_override=-1,
              heads_override=-1)
    with pytest.raises(NotImplementedError, match=match):
        PIFE(fused=False, dtype=F32, device=CPU, generator=generator(), **kw)
    with pytest.raises(NotImplementedError, match=match):
        JPIFE(**kw).init({"params": jax.random.PRNGKey(0)}, np.zeros((1, 3, 64, 32, 3)))
