"""The PyTorch port's data layer against the JAX package on the CPU: the CIF
reader, the native (C++) and NumPy neighbour searches and the eDOS 12-NN
edges, collate, the eDOS featuriser (serial, on a
process pool, without the native library, and its command line with jax
unimportable), the phDOS featuriser's pool, the store, migration and
split-statistics tools, the bundled element table, and the native library's
failures. Every comparison is exact: both packages compute on the host in
numpy (and the same C++ source), so the arrays must be equal bit for bit."""

import dataclasses
import os
import pickle
import subprocess
import sys
import types

import numpy as np
import pytest

pytest.importorskip("jax")
torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from dostransformer_tpu.data import cif as jcif  # noqa: E402
from dostransformer_tpu.data import collate as jcollate  # noqa: E402
from dostransformer_tpu.data import convert_reference_pt as jconvert  # noqa: E402
from dostransformer_tpu.data import create_store as jstore  # noqa: E402
from dostransformer_tpu.data import featurize_edos as jfeat  # noqa: E402
from dostransformer_tpu.data import featurize_phdos as jphdos  # noqa: E402
from dostransformer_tpu.data import io as jio  # noqa: E402
from dostransformer_tpu.data import neighbors as jnbr  # noqa: E402
from dostransformer_tpu.data import split_viz as jsplit  # noqa: E402
from dostransformer_tpu.data import synthetic as jsyn  # noqa: E402
from dostransformer_tpu_torch import native  # noqa: E402
from dostransformer_tpu_torch.data import (  # noqa: E402
    cif,
    convert_reference_pt,
    create_store,
    featurize_edos,
    featurize_phdos,
    graph,
    io,
    neighbors,
    split_viz,
)
from dostransformer_tpu_torch.data.synthetic import (  # noqa: E402
    synthetic_mp_records,
)
from dostransformer_tpu_torch.native import build as native_build  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# --- the CIF strings of tests/test_cif.py -----------------------------------

NACL_P1 = """\
# generated using pymatgen
data_NaCl
_symmetry_space_group_name_H-M   'P 1'
_cell_length_a   5.64000000
_cell_length_b   5.64000000
_cell_length_c   5.64000000
_cell_angle_alpha   90.00000000
_cell_angle_beta   90.00000000
_cell_angle_gamma   90.00000000
_symmetry_Int_Tables_number   1
_chemical_formula_structural   NaCl
_chemical_formula_sum   'Na1 Cl1'
_cell_volume   179.40609600
_cell_formula_units_Z   1
loop_
 _symmetry_equiv_pos_site_id
 _symmetry_equiv_pos_as_xyz
  1  'x, y, z'
loop_
 _atom_site_type_symbol
 _atom_site_label
 _atom_site_symmetry_multiplicity
 _atom_site_fract_x
 _atom_site_fract_y
 _atom_site_fract_z
 _atom_site_occupancy
  Na  Na0  1  0.00000000  0.00000000  0.00000000  1
  Cl  Cl1  1  0.50000000  0.50000000  0.50000000  1
"""

INVERSION = """\
data_test
_cell_length_a 4.0
_cell_length_b 4.0
_cell_length_c 4.0
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
loop_
 _symmetry_equiv_pos_as_xyz
 'x, y, z'
 '-x, -y, -z'
loop_
 _atom_site_type_symbol
 _atom_site_fract_x
 _atom_site_fract_y
 _atom_site_fract_z
 O  0.25 0.25 0.25
 Si 0.00 0.00 0.00
"""

TRANSLATION = """\
data_t
_cell_length_a 10
_cell_length_b 10
_cell_length_c 10
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
loop_
 _space_group_symop_operation_xyz
 '-y+1/2, x, z+0.5'
loop_
 _atom_site_label
 _atom_site_fract_x
 _atom_site_fract_y
 _atom_site_fract_z
 C1 0.1 0.2 0.3
"""

UNCERTAINTIES = """\
data_q  # trailing comment
_cell_length_a 5.4600(12)
_cell_length_b 5.4600(12)
_cell_length_c 5.4600(12)
_cell_angle_alpha 90.0
_cell_angle_beta 90.0
_cell_angle_gamma 90.0
loop_
 _atom_site_type_symbol
 _atom_site_fract_x
 _atom_site_fract_y
 _atom_site_fract_z
 Fe2+ 0.0 0.0 0.0
 O2-  0.5 0.5 0.5
"""

WRAP = """\
data_w
_cell_length_a 8
_cell_length_b 8
_cell_length_c 8
_cell_angle_alpha 90
_cell_angle_beta 90
_cell_angle_gamma 90
loop_
 _symmetry_equiv_pos_as_xyz
 'x, y, z'
 '-x, y, z'
loop_
 _atom_site_type_symbol
 _atom_site_fract_x
 _atom_site_fract_y
 _atom_site_fract_z
 H 0.00005 0.25 0.25
"""

DISORDERED = NACL_P1.replace(
    "  Cl  Cl1  1  0.50000000  0.50000000  0.50000000  1",
    "  Cl  Cl1  1  0.50000000  0.50000000  0.50000000  0.5")
NO_CELL = "data_x\nloop_\n _atom_site_fract_x\n 0.0\n"


def _assert_same(a, b):
    """Two GraphSamples (or lists of them) field for field, bit for bit."""
    if isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    for f in dataclasses.fields(b):
        va, vb = getattr(a, f.name), getattr(b, f.name)
        if isinstance(vb, np.ndarray):
            assert isinstance(va, np.ndarray) and va.dtype == vb.dtype, f.name
            np.testing.assert_array_equal(va, vb, err_msg=f.name)
        else:
            assert va == vb, f.name


@pytest.fixture(params=["native", "numpy"])
def path(request, monkeypatch):
    """Run a test on the native library and on the NumPy versions."""
    if request.param == "numpy":
        monkeypatch.setenv("DOSTPU_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("DOSTPU_NO_NATIVE", raising=False)
    return request.param


@pytest.mark.parametrize("text", [NACL_P1, INVERSION, TRANSLATION,
                                  UNCERTAINTIES, WRAP],
                         ids=["nacl_p1", "inversion", "translation",
                              "uncertainties", "wrap"])
def test_parse_cif_equals_jax(text):
    ours, ref = cif.parse_cif(text), jcif.parse_cif(text)
    assert set(ours) == set(ref) == {"numbers", "cart_coords", "lattice"}
    for k in ref:
        assert ours[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    assert featurize_edos.structure_from_cif(text)[0].tolist() == (
        ref["numbers"].tolist())


@pytest.mark.parametrize("text,match", [(DISORDERED, "occupancy"),
                                        (NO_CELL, "cell")],
                         ids=["disordered", "no_cell"])
def test_parse_cif_raises_as_jax(text, match):
    with pytest.raises(ValueError, match=match):
        cif.parse_cif(text)
    with pytest.raises(ValueError, match=match):
        jcif.parse_cif(text)


def test_lattice_from_parameters_equals_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        p = (*rng.uniform(2, 9, 3), *rng.uniform(60, 120, 3))
        np.testing.assert_array_equal(cif.lattice_from_parameters(*p),
                                      jcif.lattice_from_parameters(*p))


def _crystals(seed=0, n=12):
    """Random cells (skewed, some atoms outside the cell) and positions."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        cell = np.diag(rng.uniform(3.0, 7.0, 3)) + rng.rand(3, 3) * 0.6
        pos = rng.rand(int(rng.randint(2, 14)), 3) @ cell
        if i % 3 == 0:
            pos[0] += np.array([1, -2, 0]) @ cell
        out.append((pos, cell))
    return out


def test_neighbor_list_pbc_equals_jax(path):
    for pos, cell in _crystals():
        for pbc in ((True, True, True), (True, False, True)):
            for si in (True, False):
                got = neighbors.neighbor_list_pbc(pos, cell, 4.0, pbc, si)
                want = jnbr.neighbor_list_pbc(pos, cell, 4.0, pbc, si)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


def test_knn_edges_and_all_neighbors_equal_jax(path):
    """The 12-NN order, padding and distances bit for bit (ties keep the
    (shift, i, j) order), and pymatgen-style neighbour lists."""
    # a cubic cell: many exactly equal distances, the ties' order shows
    crystals = _crystals(seed=1) + [(np.array([[0.0, 0, 0], [1.5, 1.5, 1.5]]),
                                     np.eye(3) * 3.0)]
    for pos, cell in crystals:
        for radius in (8.0, 3.0):  # 3.0 leaves atoms with < 12, padded
            got = neighbors.knn_edges(pos, cell, radius=radius)
            want = jnbr.knn_edges(pos, cell, radius=radius)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
        assert (neighbors.get_all_neighbors(pos, cell, 5.0)
                == jnbr.get_all_neighbors(pos, cell, 5.0))


@pytest.mark.parametrize("task", ["edos", "phdos"])
def test_collate_equals_jax(task):
    make = (jsyn.synthetic_edos_samples if task == "edos"
            else jsyn.synthetic_phdos_samples)
    samples = make(5, seed=3)
    port = [graph.GraphSample(**dataclasses.asdict(s)) for s in samples]
    for b in (None, 7):  # a full batch, and one with two dummy graphs
        want = jcollate(samples, num_graphs=b, numpy=True)
        got = graph.collate(port, num_graphs=b)
        for f in dataclasses.fields(graph.GraphBatch):
            w, g = getattr(want, f.name), getattr(got, f.name)
            if w is None:
                assert g is None, f.name
            else:
                assert g.numpy().dtype == w.dtype, f.name
                np.testing.assert_array_equal(g.numpy(), w, err_msg=f.name)
    with pytest.raises(graph.RequestError):  # a pin below a sample's rows
        graph.collate(port, atoms_per_graph=2)


def _records(n=14, seed=2):
    """Seeded MP-shaped records: CIF strings (P1, P-1, P2_1/c), one record
    given as a pre-parsed structure, one missing band_gap, one missing
    efermi, and one id left out of the keep list."""
    mp_data, dos_data = synthetic_mp_records(n, seed=seed)
    ids = list(mp_data)
    numbers, coords, lattice = featurize_edos.structure_from_cif(
        mp_data[ids[1]]["cif"])
    mp_data[ids[1]]["cif"] = {"numbers": numbers.tolist(),
                              "cart_coords": coords.tolist(),
                              "lattice": lattice.tolist()}
    del mp_data[ids[4]]["band_gap"]
    del dos_data[ids[6]]["efermi"]
    keep = [k for k in ids if k != ids[9]]
    return mp_data, dos_data, keep


@pytest.mark.parametrize("workers", [0, 2])
def test_featurize_edos_equals_jax(workers, path, capsys):
    """Samples, sample ids, order and error count of load_dataset, serial
    and on a pool of 2, native and NumPy, against the JAX featuriser."""
    mp_data, dos_data, keep = _records()
    ours = featurize_edos.load_dataset(mp_data, dos_data, keep,
                                       workers=workers)
    ref = jfeat.load_dataset(mp_data, dos_data, keep)
    assert capsys.readouterr().out.count("Converted 11 | errors 2") == 2
    assert [s.sample_id for s in ours] == [
        i for i in range(14) if i not in (4, 6, 9)]
    _assert_same(ours, ref)


def test_featurize_edos_helpers_equal_jax(tmp_path):
    """The bundled table's bytes, the standardised table in all three
    forms, the Gaussian expansion and one sample built from a CIF."""
    src = os.path.join(REPO, "dostransformer_tpu", "data",
                       "matscholar_embedding.npz")
    ours = os.path.join(REPO, "dostransformer_tpu_torch", "data",
                        "matscholar_embedding.npz")
    with open(src, "rb") as a, open(ours, "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(featurize_edos.load_elem_feats(),
                                  jfeat.load_elem_feats())
    table = featurize_edos.load_matscholar_table()
    path = tmp_path / "embs.json"
    from dostransformer_tpu_torch.data.elements import SYMBOLS
    import json

    path.write_text(json.dumps({SYMBOLS[z]: table[z].tolist()
                                for z in range(100)}))
    np.testing.assert_array_equal(featurize_edos.load_elem_feats(str(path)),
                                  jfeat.load_elem_feats(str(path)))
    with pytest.raises(RuntimeError, match="mendeleev"):
        featurize_edos.load_elem_feats("mendeleev")
    d = np.linspace(0.0, 9.0, 37)
    np.testing.assert_array_equal(featurize_edos.gaussian_expand(d),
                                  jfeat.gaussian_expand(d))
    x = np.random.RandomState(0).randn(9, 4)
    np.testing.assert_array_equal(featurize_edos.standardize_columns(x),
                                  jfeat.standardize_columns(x))
    y = np.abs(np.sin(np.linspace(0, 3, 201))) + 0.1
    kw = dict(y=y, y_ft=y * 2, glob=[-1.0, -2.0], crystal_system="cubic",
              band_gap=1.0, efermi=0.5, mp_id="mp-test", sample_id=3)
    args = (featurize_edos.load_elem_feats(),
            *featurize_edos.structure_from_cif(NACL_P1))
    _assert_same(featurize_edos.build_sample(*args, **kw),
                 jfeat.build_sample(*args, **kw))


_BLOCKED = """
import importlib.abc, importlib.machinery, runpy, sys
class Blocked(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    # found, as an installed package is, but importing it fails
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax", "pandas",
                                  "dostransformer_tpu"):
            return importlib.machinery.ModuleSpec(name, self)
    def create_module(self, spec):
        return None
    def exec_module(self, module):
        raise ImportError(module.__name__ + " is not installed here")
sys.meta_path.insert(0, Blocked())
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name="__main__", alter_sys=True)
"""


def test_featurize_edos_command_runs_without_jax(tmp_path):
    """python -m dostransformer_tpu_torch.data.featurize_edos with jax,
    flax, pandas and the JAX package unimportable, serial, with
    --workers 2 and with DOSTPU_NO_NATIVE=1: each npz holds the JAX
    featuriser's samples."""
    mp_data, dos_data, _ = _records(n=10, seed=4)
    for name, obj in (("mp.pkl", mp_data), ("dos.pkl", dos_data)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(obj, f)
    ref = jfeat.load_dataset(mp_data, dos_data, list(mp_data))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    for i, (extra, no_native) in enumerate(
            (([], False), (["--workers", "2"], False), ([], True))):
        out = tmp_path / f"out{i}.npz"
        run_env = dict(env, DOSTPU_NO_NATIVE="1") if no_native else env
        proc = subprocess.run(
            [sys.executable, "-c", _BLOCKED,
             "dostransformer_tpu_torch.data.featurize_edos",
             str(tmp_path / "mp.pkl"), str(tmp_path / "dos.pkl"), str(out),
             *extra], env=run_env, cwd=REPO, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        assert "Converted 8 | errors 2" in proc.stdout
        _assert_same(io.load_samples(out), jio.load_samples(str(out)))
        _assert_same(io.load_samples(out), ref)


def test_featurize_csv_pool_equals_jax(tmp_path, path):
    from test_featurize_csv import _make_csv  # phononDoS-style rows

    csv_path = tmp_path / "data.csv"
    _make_csv(str(csv_path), n=10)
    ours, sp = featurize_phdos.featurize_csv(str(csv_path), workers=2)
    ref, jsp = jphdos.featurize_csv(str(csv_path))
    assert sp == jsp
    _assert_same(ours, ref)
    featurize_phdos.main([str(csv_path), str(tmp_path / "p.npz"),
                          "--workers", "2"])
    _assert_same(io.load_samples(tmp_path / "p.npz"), ref)


def test_create_store_equals_jax(tmp_path):
    import json

    dos_raw, mp_raw = tmp_path / "dos_ft", tmp_path / "mpdata"
    dos_raw.mkdir()
    mp_raw.mkdir()
    (dos_raw / "mp-123_dos.json").write_text(json.dumps({"efermi": 1.0}))
    (dos_raw / "mp-456_dos.json").write_text(json.dumps({"efermi": 2.0}))
    (dos_raw / "broken__dos.json").write_text("{not json")
    (dos_raw / "short").write_text("{}")
    (mp_raw / "a.json").write_text(json.dumps(
        {"response": [{"material_id": "mp-7", "band_gap": 0.5}]}))
    (mp_raw / "b.json").write_text(json.dumps({"response": []}))
    (mp_raw / "c.bin").write_bytes(b"\xff\xfe\x00")
    for make, raw in ((create_store.create_dos_store, dos_raw),
                      (create_store.create_mp_store, mp_raw)):
        jmake = getattr(jstore, make.__name__)
        assert make(str(raw), str(tmp_path / "ours.pkl")) == jmake(
            str(raw), str(tmp_path / "ref.pkl"))
        with open(tmp_path / "ours.pkl", "rb") as a, \
                open(tmp_path / "ref.pkl", "rb") as b:
            assert pickle.load(a) == pickle.load(b)
    create_store.main(["--dos_raw", str(dos_raw), "--mp_raw", str(mp_raw),
                       "--dos_out", str(tmp_path / "d.pkl"), "--mp_out",
                       str(tmp_path / "m.pkl")])
    with open(tmp_path / "m.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"mp-7"}


def _fake_reference_pt(path, n=3, seed=0):
    """A .pt like the reference's dos_dataset_random.pt: a list of objects
    pickled under the torch_geometric.data.data.Data path (as
    tests/test_convert_pt.py builds it)."""
    mod = types.ModuleType("torch_geometric.data.data")

    class Data:
        pass

    Data.__module__ = "torch_geometric.data.data"
    Data.__qualname__ = "Data"
    mod.Data = Data
    sys.modules["torch_geometric"] = types.ModuleType("torch_geometric")
    sys.modules["torch_geometric.data"] = types.ModuleType(
        "torch_geometric.data")
    sys.modules["torch_geometric.data.data"] = mod
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        d = Data()
        n_atoms = int(rng.randint(3, 7))
        d.x = torch.tensor(rng.randn(n_atoms + 1, 200), dtype=torch.float)
        d.edge_index = torch.tensor(
            np.stack([np.repeat(np.arange(n_atoms), 12),
                      rng.randint(0, n_atoms, n_atoms * 12)]),
            dtype=torch.long)
        d.edge_attr = torch.tensor(rng.rand(n_atoms * 12, 41),
                                   dtype=torch.float)
        y = torch.tensor(np.abs(rng.randn(201)), dtype=torch.float)
        d.y = y / y.max()
        d.y_ft = y / y.max()
        d.y_max = torch.tensor(float(y.max()))
        d.glob = torch.tensor(rng.randn(2), dtype=torch.float)
        d.band_gap = torch.tensor(0.5)
        d.efermi = torch.tensor(1.5)
        d.system = torch.tensor(i % 7)
        d.mp_id = f"mp-{i}"
        d.coords = torch.tensor(rng.randn(n_atoms, 3), dtype=torch.float)
        d.z = torch.eye(100)[torch.tensor(rng.randint(0, 100, n_atoms))]
        items.append(d)
    incomplete = Data()  # no y_ft: skipped by both converters
    incomplete.x = torch.zeros(2, 200)
    incomplete.edge_index = torch.zeros(2, 0, dtype=torch.long)
    items.append(incomplete)
    torch.save(items, path)
    for m in ("torch_geometric", "torch_geometric.data",
              "torch_geometric.data.data"):
        del sys.modules[m]


def test_convert_reference_pt_equals_jax(tmp_path):
    pt = tmp_path / "dos_dataset_random.pt"
    _fake_reference_pt(str(pt))
    ours = convert_reference_pt.convert(str(pt), str(tmp_path / "ours.npz"))
    ref = jconvert.convert(str(pt), str(tmp_path / "ref.npz"))
    assert "torch_geometric" not in sys.modules and len(ref) == 3
    _assert_same(ours, ref)
    _assert_same(jio.load_samples(str(tmp_path / "ours.npz")),
                 jio.load_samples(str(tmp_path / "ref.npz")))


def test_split_statistics_equal_jax(tmp_path):
    from dostransformer_tpu_torch.data.datasets import element_balanced_split

    rng = np.random.RandomState(5)
    symbols = ["Na", "Cl", "O", "Si", "Fe", "Li", "Mg"]
    species = [sorted(set(rng.choice(symbols, rng.randint(1, 4))))
               for _ in range(60)]
    tr, va, te = element_balanced_split(species, 0.1, 0.1, seed=12)
    splits = {"train": tr, "valid": va, "test": te}
    ours = split_viz.split_element_statistics(species, splits)
    ref = jsplit.split_element_statistics(species, splits)
    assert ours["species"] == ref["species"]
    np.testing.assert_array_equal(ours["counts"], ref["counts"])
    for k in splits:
        np.testing.assert_array_equal(ours["fractions"][k],
                                      ref["fractions"][k])
    assert (split_viz.element_representation([1, 2, 3], [2, 3, 9])
            == jsplit.element_representation([1, 2, 3], [2, 3, 9]))
    out = split_viz.plot_split_statistics(ours, str(tmp_path / "s.png"))
    assert os.path.getsize(out) > 0


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed build, or a library of another ABI version, raises
    NativeError; the NumPy path is taken only when DOSTPU_NO_NATIVE=1 asks
    for it."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "CXX_FLAGS", ("--no-such-flag",))
    monkeypatch.delenv("DOSTPU_NO_NATIVE", raising=False)
    pos, cell = np.zeros((1, 3)), np.eye(3) * 4.0
    with pytest.raises(native.NativeError, match="DOSTPU_NO_NATIVE"):
        neighbors.neighbor_list_pbc(pos, cell, 3.0)
    monkeypatch.setenv("DOSTPU_NO_NATIVE", "1")
    got = neighbors.neighbor_list_pbc(pos, cell, 3.0)
    assert got[0].tolist() == [0]  # the self pair, on the NumPy path

    src = tmp_path / "old.cc"
    src.write_text('extern "C" long long dostpu_abi_version() { return 2; }\n')
    old = tmp_path / "libold.so"
    subprocess.run(["g++", "-shared", "-fPIC", str(src), "-o", str(old)],
                   check=True)
    monkeypatch.setattr(native_build, "build", lambda: old)
    with pytest.raises(native.NativeError, match="ABI version 2"):
        native.library()


@pytest.mark.parametrize("workers", [0, 2])
def test_featurize_edos_build_failure_raises(workers, tmp_path, monkeypatch,
                                             capsys):
    """The featuriser's command stops on a failed native build, serial and
    on a pool, before any record is read: no record is dropped for it and
    no npz is written."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native_build, "CXX_FLAGS", ("--no-such-flag",))
    monkeypatch.delenv("DOSTPU_NO_NATIVE", raising=False)
    mp_data, dos_data = synthetic_mp_records(4, seed=2)
    pkl = [str(tmp_path / n) for n in ("mp.pkl", "dos.pkl")]
    for path, obj in zip(pkl, (mp_data, dos_data)):
        with open(path, "wb") as f:
            pickle.dump(obj, f)
    out = tmp_path / "out.npz"
    with pytest.raises(native.NativeError, match="no-such-flag"):
        featurize_edos.main([*pkl, str(out), "--workers", str(workers)])
    with pytest.raises(native.NativeError):
        featurize_edos.load_dataset(mp_data, dos_data, list(mp_data),
                                    workers=workers)
    assert not out.exists() and "Converted" not in capsys.readouterr().out
    # a fault of the library raised inside a record's task is not a record
    # error either
    monkeypatch.setattr(featurize_edos, "structure_from_cif", _raise_native)
    featurize_edos._edos_pool_init(featurize_edos.load_elem_feats(), 8.0)
    with pytest.raises(native.NativeError):
        featurize_edos._edos_pool_task((0, "mp-0", {"cif": ""}, {}))


def _raise_native(_):
    raise native.NativeError("stand-in fault")


def test_library_name_follows_host_and_compiler(monkeypatch):
    """A checkout copied to a host of another machine type, or with another
    compiler, builds a library of its own rather than loading this one."""
    here = native_build.library_path()
    monkeypatch.setattr(native_build.platform, "machine", lambda: "other")
    assert native_build.library_path() != here
    monkeypatch.undo()
    real = native_build._run_compiler
    monkeypatch.setattr(
        native_build, "_run_compiler",
        lambda cmd: (types.SimpleNamespace(stdout="0.0.1\n")
                     if "-dumpfullversion" in cmd else real(cmd)))
    assert native_build.library_path() != here
