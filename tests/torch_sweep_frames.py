"""What a frame's sweep (K1 or K7) is built from, for the port's sweep
tests: they rebuild the sweep's inputs from these at other tile heights,
signs or windows of the grid."""

from vkvolume_tpu_torch.render import sweep_frame


def frame_parts(eng, cam, width: int, height: int) -> dict:
    """Renders one frame and returns its pose's pieces: the uniforms ``u``,
    the slice axis ``p``, the ``plan``, the grid scalars ``gp``, the
    slice-major volume ``vol_t``, the occupancy ``occ_t``, the ``tf``, the
    gradient map ``grad_t`` (None without a gradient TF) and ``n_slabs``."""
    eng.render(cam, width, height)
    v = eng.volumes[0]
    key = (cam.view.tobytes(), cam.proj.tobytes())
    pose = next(p for k, p in v._sweep_cache.items()
                if isinstance(k, tuple) and k[0] == "pose"
                and k[1][:2] == key)
    occ_t = next(t for k, t in v._sweep_cache.items()
                 if isinstance(k, tuple) and k[0] == "occ")
    plan, p = pose["plan"], pose["view"]["p_axis"]
    u, _, gp, _ = sweep_frame.unpack_frame_scalars(pose["packed"])
    vol_t = v._sweep_cache[p]
    tf = eng._tf(v)
    n_slabs = int(max(2, round(vol_t.shape[0] * eng._slab_oversample(
        v, vol_t.shape, tf))))
    return dict(u=u, p=p, plan=plan, gp=gp, vol_t=vol_t, occ_t=occ_t, tf=tf,
                grad_t=v._sweep_cache.get(("grad", p)), n_slabs=n_slabs)
