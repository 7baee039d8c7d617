"""``ops/solve_kernel.solve_roots`` and the soft render's branch B
(``diff/soft._raw_roots_excluding_pair``) on the CPU: CPU tensors take the
plain versions, bit for bit, and launch nothing; the branch B launcher
refuses what its kernel does not take; the broadcast-and-stride layout the
wrappers hand the kernels addresses the elements the plain version reads;
the kernels' expansion and monomial tables are ``ops/poly.py``'s, row for
row, and csrc/ holds one copy of them and of the solve's device functions;
their source alone is built without contracted multiply-adds. (The kernels
against the plain versions on the card are ``test_solve_roots_*`` and
``test_excluding_pair_*`` in tests/test_torch_gpu.py.)"""

import dataclasses
import math
import pathlib
import re

import pytest
import torch

import tpu_ray_tracer_torch as ttt
from tpu_ray_tracer_torch.models.surface import MONOMIAL_POWERS
from tpu_ray_tracer_torch.ops import camera as camera_ops
from tpu_ray_tracer_torch.ops.intersect import intersect_all
from tpu_ray_tracer_torch.ops.poly import _EXPANSION
from tpu_ray_tracer_torch.diff.soft import _excluding_pair_plain, _raw_roots_excluding_pair
from tpu_ray_tracer_torch.ops.solve_kernel import (_solve_plain, roots_excluding_pair,
                                                   solve_layout, solve_roots)
from tpu_ray_tracer_torch.render import _build, graphs

SCENE_DIR = pathlib.Path(__file__).resolve().parent.parent / "scenes"


def _rays(name, dtype, width=16, height=12):
    """(coefs, origin [H, W, 3] expanded from one eye, dir [H, W, 3]) of a
    bundled scene at a small size."""
    scene = ttt.load_from_file(SCENE_DIR / f"{name}.yml", device="cpu")
    scene = dataclasses.replace(scene, width=width, height=height).astype(dtype)
    cam = ttt.Camera(position=torch.tensor([0.0, 0.5, -1.0]), yaw_deg=torch.tensor(88.0),
                     pitch_deg=torch.tensor(-4.0)).to(dtype)
    rot, eye = camera_ops.camera_frame(cam)
    dirs = camera_ops.pixel_directions(rot, width, height, scene.aspect_ratio,
                                       scene.tan_half_fov)
    return scene.coefs, eye.expand(dirs.shape), dirs


def _shadow(coefs, origin, dirs, lights=3):
    """A stacked shadow solve's layout: origin [2, H, W, 1, 3] against dir
    [2, H, W, L, 3] (the soft render's two branches)."""
    point = origin + 2.0 * dirs
    sdir = torch.nn.functional.normalize(
        torch.linspace(-1.0, 1.0, lights * 3, dtype=dirs.dtype).reshape(lights, 3) + 0.3, dim=-1)
    sdir = sdir.expand(point.shape[:-1] + (lights, 3))
    return (torch.stack([point, point + 0.01])[..., None, :],
            torch.stack([sdir, sdir.flip(-1)]))


@pytest.mark.parametrize("shape", ["primary", "shadow"])
@pytest.mark.parametrize("dtype,polish", [(torch.float32, 3), (torch.float64, 0)],
                         ids=["f32_polish3", "f64_polish0"])
def test_cpu_tensors_take_the_plain_solve(shape, dtype, polish):
    """On the CPU ``solve_roots`` is ``_solve_plain``, bit for bit, and so is
    ``intersect_all``'s forward; no kernel launches."""
    coefs, origin, dirs = _rays("clebsch" if shape == "primary" else "dingdong", dtype)
    if shape == "shadow":
        origin, dirs = _shadow(coefs, origin, dirs)
    before = graphs.launch_counts()["solve_roots"]
    got = solve_roots(coefs, origin, dirs, polish)
    want = _solve_plain(coefs, origin, dirs, polish)
    assert got.shape == torch.broadcast_shapes(origin.shape, dirs.shape)[:-1] + coefs.shape[:1]
    assert got.dtype == dtype and torch.equal(got.view(torch.int8), want.view(torch.int8))
    assert torch.equal(intersect_all(coefs, origin, dirs, polish).view(torch.int8),
                       want.view(torch.int8))
    assert graphs.launch_counts()["solve_roots"] == before == solve_roots.launches


def _kinds(form, coefs):
    """branch B's ``pair_kinds`` in each form a caller passes: None, the
    problem's tuple (``InverseProblem``'s, from the template), its bool mask
    on the coefficients' device, and a mask that makes every object
    cubic-class (its quadric entries then keep their normal root)."""
    cubic = tuple((coefs[:, :10].abs() > 0).any(1).tolist())
    return {"none": None, "tuple": cubic,
            "mask": torch.tensor(cubic, dtype=torch.bool, device=coefs.device),
            "all_cubic": torch.ones(coefs.shape[0], dtype=torch.bool, device=coefs.device),
            }[form]


@pytest.mark.parametrize("given", [True, False], ids=["t_normal", "no_t_normal"])
@pytest.mark.parametrize("form", ["none", "tuple", "mask", "all_cubic"])
@pytest.mark.parametrize("dtype,polish", [(torch.float32, 2), (torch.float64, 0)],
                         ids=["f32_polish2", "f64_polish0"])
def test_cpu_tensors_take_the_plain_excluding_pair(form, given, dtype, polish):
    """On the CPU branch B's root table is ``_excluding_pair_plain``'s, bit
    for bit, with each form of ``pair_kinds`` and with ``t_normal`` given or
    made by ``intersect_all``; neither kernel launches."""
    coefs, origin, dirs = _rays("dingdong", dtype)
    kinds = _kinds(form, coefs)
    t_normal = intersect_all(coefs, origin, dirs, polish) if given else None
    before = graphs.launch_counts()
    got = _raw_roots_excluding_pair(coefs, origin, dirs, polish, kinds, t_normal)
    want = _excluding_pair_plain(coefs, origin, dirs, polish, kinds, t_normal)
    assert got.shape == dirs.shape[:-1] + coefs.shape[:1] and got.dtype == dtype
    assert torch.equal(got.view(torch.int8), want.view(torch.int8))
    # the table the plain version makes itself is the one it is given
    assert torch.equal(want, _excluding_pair_plain(coefs, origin, dirs, polish, kinds,
                                                   intersect_all(coefs, origin, dirs, polish)))
    assert graphs.launch_counts() == before
    assert roots_excluding_pair.launches == before["roots_excluding_pair"]


def _refused(case):
    """(function, arguments, what the error names) of one input the branch B
    launcher refuses: each check is reached on CPU tensors, the device's
    last; meta tensors through the dispatcher reach the launcher, not the
    plain version."""
    coefs, origin, dirs = _rays("dingdong", torch.float32)
    t = intersect_all(coefs, origin, dirs, 2)
    kinds = _kinds("mask", coefs)
    ok = (coefs, origin, dirs, 2, kinds, t)
    meta = [x.to("meta") for x in (coefs, origin, dirs)]
    return {
        "half": (roots_excluding_pair, (coefs.half(), origin.half(), dirs.half(), 2, kinds,
                                        t.half()), "f32 or f64"),
        "mixed_rays": (roots_excluding_pair, (coefs, origin.double(), dirs, 2, kinds, t),
                       "f32 or f64"),
        "coefs_shape": (roots_excluding_pair, (coefs[:, :10], *ok[1:]), "coefs must be"),
        "ray_shape": (roots_excluding_pair, (coefs, origin[..., :2], dirs[..., :2], 2, kinds,
                                             t), "origin and dir must be"),
        "t_normal_dtype": (roots_excluding_pair, (*ok[:5], t.double()), "t_normal"),
        "t_normal_shape": (roots_excluding_pair, (*ok[:5], t[..., :1]), "t_normal"),
        "t_normal_strided": (roots_excluding_pair,
                             (*ok[:5], t.permute(2, 0, 1).contiguous().permute(1, 2, 0)),
                             "t_normal"),
        "kinds_dtype": (roots_excluding_pair, (*ok[:4], kinds.to(torch.uint8), t), "kinds"),
        "kinds_shape": (roots_excluding_pair, (*ok[:4], kinds[:2], t), "kinds"),
        "cpu": (roots_excluding_pair, ok, "one CUDA device"),
        "meta": (_raw_roots_excluding_pair, (*meta, 2, None, t.to("meta")), "one CUDA device"),
    }[case]


@pytest.mark.parametrize("case", ["half", "mixed_rays", "coefs_shape", "ray_shape",
                                  "t_normal_dtype", "t_normal_shape", "t_normal_strided",
                                  "kinds_dtype", "kinds_shape", "cpu", "meta"])
def test_excluding_pair_refuses_what_it_does_not_take(case):
    """The branch B launcher raises on a half-precision table, rays of two
    dtypes, coefficients not [N, 20], rays not [..., 3], a ``t_normal`` of
    another dtype or shape or not contiguous, a mask not a bool [N], and
    tensors off one CUDA device, and launches nothing; the dispatcher sends
    tensors off the CPU to it, never to the plain version."""
    fn, args, says = _refused(case)
    before = roots_excluding_pair.launches
    with pytest.raises(ValueError, match=says):
        fn(*args)
    assert roots_excluding_pair.launches == before


def _layout_cases():
    coefs, origin, dirs = _rays("clebsch", torch.float32, 8, 6)
    so, sd = _shadow(coefs, origin, dirs)
    flat = dirs.reshape(-1, 3)
    return {
        # the pipeline's primary solve: one eye expanded over [H, W]
        "primary": (origin, dirs),
        # shade_roots' shadow solve of the soft render's stacked branches
        "shadow": (so, sd),
        # render_rays_soft's branches stacked by expand: stride 0 outermost
        "soft_stacked": (origin.reshape(-1, 3).expand((2,) + flat.shape),
                         flat.expand((2,) + flat.shape)),
        # a transposed origin (x, y, z 5 apart) of fewer dimensions against
        # every other ray of a batch
        "strided": (torch.randn(3, 5).t(), torch.randn(7, 10, 3)[:, ::2, :]),
    }


@pytest.mark.parametrize("case", ["primary", "shadow", "soft_stacked", "strided"])
def test_layout_reaches_each_rays_elements(case):
    """The kernel's reads, as ``solve_layout`` describes them (each ray's
    index cut into the digits of ``dims``, outermost first, times each
    tensor's element strides, plus the component's stride), give every
    broadcast ray's origin and direction."""
    origin, dirs = _layout_cases()[case]
    batch, dims, o_comp, d_comp = solve_layout(origin, dirs)
    assert batch == tuple(torch.broadcast_shapes(origin.shape, dirs.shape)[:-1])
    assert math.prod(size for size, _, _ in dims) == math.prod(batch)
    assert all(size > 1 for size, _, _ in dims)
    want_o, want_d = (t.expand(batch + (3,)).reshape(-1, 3) for t in (origin, dirs))
    for tensor, comp, which, want in ((origin, o_comp, 1, want_o), (dirs, d_comp, 2, want_d)):
        offsets = torch.zeros(math.prod(batch), dtype=torch.int64)
        rest = torch.arange(math.prod(batch))
        for dim in reversed(dims):
            offsets += (rest % dim[0]) * dim[which]
            rest = rest // dim[0]
        span = int(offsets.max()) + 2 * comp + 1
        storage = torch.as_strided(tensor, (span,), (1,))
        got = torch.stack([storage[offsets + a * comp] for a in range(3)], dim=-1)
        assert torch.equal(got, want), which


def test_layout_merges_and_drops():
    """The primary solve's [H, W] batch is one dimension, the stacked shadow
    solve's two (rays and lights), and a layout that needs more than
    MAX_DIMS dimensions raises."""
    cases = _layout_cases()
    assert solve_layout(*cases["primary"])[1] == [(48, 0, 3)]
    assert solve_layout(*cases["shadow"])[1] == [(96, 3, 9), (3, 0, 3)]
    assert solve_layout(*cases["soft_stacked"])[1] == [(2, 0, 0), (48, 0, 3)]
    assert solve_layout(*cases["strided"])[1:] == ([(7, 0, 30), (5, 1, 6)], 5, 1)
    deep = torch.zeros((2,) * 8 + (3,))
    with pytest.raises(ValueError, match="more than"):
        solve_layout(deep.permute(*range(7, -1, -1), 8), deep)


def expansion_rows() -> list:
    """The rows of the kernel's expansion table, ``ops.poly._EXPANSION`` in
    the plain version's order: for k = 3, 2, 1, 0 and each monomial m with a
    t^k term, ``TERM(k, m, first, weight, ox, oy, oz, dx, dy, dz)`` for each
    binomial term (origin powers o, direction powers d; ``first`` starts
    the column), then ``COLUMN(k, m, first)`` (``first`` starts t^k's
    sum). The source's ``TRT_EXPANSION`` is these rows, written out."""
    rows = []
    for k in range(3, -1, -1):
        first_column = 1
        for m, terms in enumerate(_EXPANSION[k]):
            for i, (weight, o_pows, d_pows) in enumerate(terms):
                rows.append(f"TERM({k}, {m}, {int(i == 0)}, {int(weight)}, "
                            + ", ".join(str(e) for e in (*o_pows, *d_pows)) + ")")
            if terms:
                rows.append(f"COLUMN({k}, {m}, {first_column})")
                first_column = 0
    return rows


def monomial_rows() -> list:
    """The rows of the kernel's monomial table, ``MONOMIAL_POWERS`` in order:
    ``MONO(m, px, py, pz)``."""
    return [f"MONO({m}, {px}, {py}, {pz})" for m, (px, py, pz) in enumerate(MONOMIAL_POWERS)]


def _source_rows(macro: str) -> list:
    """The rows of ``csrc/solve_roots.cu``'s X-macro ``macro``, as written."""
    text = (_build._CSRC / "solve_roots.cu").read_text()
    start = re.search(rf"#define {macro}\([A-Z, ]+\) \\\n", text).end()
    rows = []
    for line in text[start:].splitlines():
        rows.append(line.strip().rstrip("\\").strip())
        if not line.endswith("\\"):
            break
    return rows


@pytest.mark.parametrize("k", [3, 2, 1, 0])
def test_kernel_expansion_table_is_ops_poly(k):
    """The kernel's expansion table is ``ops.poly._EXPANSION`` in the plain
    version's order, for each power of t: the binomial terms of each
    monomial's column, and the columns in m order."""
    def of_power(rows):
        return [r for r in rows if re.match(rf"(TERM|COLUMN)\({k},", r)]

    source = _source_rows("TRT_EXPANSION")
    assert len(source) == len(expansion_rows())
    assert of_power(source) == of_power(expansion_rows()) != []


def test_kernel_monomial_table_is_monomial_powers():
    """The kernel's monomial table is ``MONOMIAL_POWERS`` in order, and the
    first monomial with a power of x, y and z is m = 0, 1 and 2 (the kernel's
    gradient sums start there)."""
    rows = _source_rows("TRT_MONOMIALS")
    assert rows == monomial_rows()
    powers = [tuple(int(v) for v in re.findall(r"\d+", r)[1:]) for r in rows]
    assert [next(m for m, p in enumerate(powers) if p[axis]) for axis in range(3)] == [0, 1, 2]


def test_only_the_solve_is_built_uncontracted():
    """``csrc/solve_roots.cu`` is built with -fmad=false, every other source
    with the flags it had."""
    assert "-fmad=false" in _build.nvcc_flags("solve_roots")
    assert "-fmad=true" not in _build.nvcc_flags("solve_roots")
    for name in ("render_fwd", "render_bwd", "pack", "select_rows"):
        assert _build.nvcc_flags(name) == _build.NVCC_FLAGS


def test_excluding_pair_kernel_is_built_uncontracted():
    """Branch B's kernel is a second entry of ``csrc/solve_roots.cu``, so it
    is built with the solve's -fmad=false (every multiply and add rounds on
    its own, as each aten kernel of its plain version does)."""
    defined_in = [p.name for p in sorted(_build._CSRC.glob("*.cu"))
                  if re.search(r"__global__ void\b[^;{]*\broots_excluding_pair_kernel\(",
                               p.read_text())]
    assert defined_in == ["solve_roots.cu"]
    assert "-fmad=false" in _build.nvcc_flags("solve_roots")
    assert set(_build._SIGNATURES["solve_roots"]) == {"trt_solve_roots",
                                                      "trt_roots_excluding_pair"}


# One definition each in csrc/ of the solve's tables and device functions,
# which both of solve_roots.cu's entries share (K1's own polish, in
# render_fwd.cu, follows the Pallas kernel's algorithm on floats).
SHARED_DEFINITIONS = {
    "expansion": r"#define TRT_EXPANSION\(",
    "monomials": r"#define TRT_MONOMIALS\(",
    "polish": r"\bT polish\(T t,",
    "cbrt": r"\bT cbrt_\(T x\)",
    "depressed": r"\bDepressed<T> depressed\(",
    "cardano": r"\bT cardano\(const Depressed<T>& d",
    "trig_roots": r"\bvoid trig_roots\(const Depressed<T>& d",
    "quadratic_roots": r"\bT quadratic_roots\(",
    "expand_entry": r"\bvoid expand_entry\(",
}


@pytest.mark.parametrize("name", list(SHARED_DEFINITIONS))
def test_csrc_holds_one_copy_of_the_solve(name):
    """csrc/ defines the expansion and monomial tables, the polish, the cube
    root, the depressed cubic, Cardano's and the trigonometric roots, the
    quadratic's and a ray's expansion once, in solve_roots.cu, and both of
    its kernels call the shared ones: no third copy of the solve."""
    pattern = SHARED_DEFINITIONS[name]
    found = {p.name: len(re.findall(pattern, p.read_text()))
             for p in sorted(_build._CSRC.glob("*.cu*"))}
    assert {k: v for k, v in found.items() if v} == {"solve_roots.cu": 1}
    text = (_build._CSRC / "solve_roots.cu").read_text()
    for kernel in ("solve_roots_kernel", "roots_excluding_pair_kernel"):
        body = text[text.index(f"__launch_bounds__(BLOCK) {kernel}("):]
        body = body[:body.index("\n}\n")]
        assert "expand_entry(" in body, kernel
