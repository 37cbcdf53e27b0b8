"""Dependency-free CIF reader for Materials-Project-style crystal files.

The port's copy of dostransformer_tpu/data/cif.py (same results, bit for
bit). The reference parses CIF strings with pymatgen
(``Structure.from_str(str_cif, fmt='cif')``, mat2graph.py:121) and uses three
things of the structure: atomic numbers, cartesian coordinates and the 3x3
lattice matrix. This module reads the subset of CIF those files use, so
featurising runs without pymatgen:

  * cell parameters (``_cell_length_*``, ``_cell_angle_*``), with ``4.56(3)``
    style standard uncertainties stripped;
  * ``loop_`` tables, quoted values (``'x, y, z'``), ``#`` comments and
    semicolon text blocks;
  * atom sites from ``_atom_site_fract_{x,y,z}`` +
    ``_atom_site_type_symbol`` (else ``_atom_site_label``), oxidation-state
    suffixes (``Fe2+``, ``O2-``) stripped;
  * symmetry expansion from ``_symmetry_equiv_pos_as_xyz`` /
    ``_space_group_symop_operation_xyz`` ops (``'-y+1/2, x-y, z'`` style),
    images wrapped into the cell and duplicates dropped on the fractional
    grid: P1 files (what pymatgen's CifWriter writes for Materials Project
    records) and symmetry-compressed ones alike.

The lattice matrix follows pymatgen's ``Lattice.from_parameters`` row-vector
convention (a in the xz-plane, c along z).

A disordered site (occupancy < 1) or a missing cell or atom loop raises
ValueError.
"""

from __future__ import annotations

import math
import re

import numpy as np

from dostransformer_tpu_torch.data.elements import SYMBOL_TO_Z

__all__ = ["parse_cif", "lattice_from_parameters"]


# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------


def _tokenize(text: str):
    """CIF tokens in order: tags (``_name``), bare values, quoted values and
    semicolon text blocks (the latter two yielded as plain strings), plus the
    structural keywords ``loop_`` / ``data_*``."""
    lines = text.splitlines()
    i = 0
    while i < len(lines):
        line = lines[i]
        if line.startswith(";"):
            # multi-line text field: everything until the next ';' line
            block = [line[1:]]
            i += 1
            while i < len(lines) and not lines[i].startswith(";"):
                block.append(lines[i])
                i += 1
            i += 1  # the closing ';'
            yield "\n".join(block).strip()
            continue
        pos, n = 0, len(line)
        while pos < n:
            ch = line[pos]
            if ch in " \t":
                pos += 1
                continue
            if ch == "#":
                break  # comment to end of line
            if ch in "'\"":
                end = line.find(ch, pos + 1)
                if end < 0:
                    end = n
                yield line[pos + 1:end]
                pos = end + 1
                continue
            m = re.match(r"\S+", line[pos:])
            yield m.group(0)
            pos += m.end()
        i += 1


def _parse_number(tok: str) -> float:
    """Numeric CIF value; strips a parenthesised standard uncertainty
    (``5.4600(12)`` -> 5.46) and handles ``.``/``?`` unknowns as NaN."""
    tok = tok.strip()
    if tok in (".", "?"):
        return float("nan")
    m = re.match(r"^([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)(?:\(\d+\))?$",
                 tok)
    if not m:
        raise ValueError(f"not a CIF number: {tok!r}")
    return float(m.group(1))


# ---------------------------------------------------------------------------
# document model: tags + loops
# ---------------------------------------------------------------------------


def _parse_document(text: str):
    """First data block -> (scalars: {tag: value}, loops: [({tag: col}, rows)]).

    Tags are lowercased (CIF tags are case-insensitive)."""
    scalars: dict[str, str] = {}
    loops: list[dict[str, list[str]]] = []
    toks = list(_tokenize(text))
    i, n = 0, len(toks)
    seen_data = False
    while i < n:
        tok = toks[i]
        low = tok.lower()
        if low.startswith("data_"):
            if seen_data:
                break  # only the first data block
            seen_data = True
            i += 1
        elif low == "loop_":
            i += 1
            tags: list[str] = []
            while i < n and toks[i].startswith("_"):
                tags.append(toks[i].lower())
                i += 1
            values: list[str] = []
            while i < n and not toks[i].startswith("_") \
                    and toks[i].lower() not in ("loop_",) \
                    and not toks[i].lower().startswith("data_"):
                values.append(toks[i])
                i += 1
            if tags and len(values) % len(tags) == 0:
                cols = {t: values[j::len(tags)] for j, t in enumerate(tags)}
                loops.append(cols)
            elif tags:
                raise ValueError(
                    f"CIF loop with {len(tags)} tags has {len(values)} "
                    "values (not a multiple)")
        elif tok.startswith("_"):
            if i + 1 < n and not toks[i + 1].startswith("_") \
                    and toks[i + 1].lower() != "loop_":
                scalars[low] = toks[i + 1]
                i += 2
            else:
                scalars[low] = ""
                i += 1
        else:
            i += 1  # stray value (e.g. global_) — skip
    return scalars, loops


# ---------------------------------------------------------------------------
# lattice
# ---------------------------------------------------------------------------


def lattice_from_parameters(a, b, c, alpha, beta, gamma) -> np.ndarray:
    """Row-vector lattice matrix, pymatgen ``Lattice.from_parameters``
    convention (angles in degrees): a in the xz-plane, c along +z."""
    alpha_r, beta_r, gamma_r = (math.radians(x) for x in (alpha, beta, gamma))
    val = (math.cos(alpha_r) * math.cos(beta_r) - math.cos(gamma_r)) \
        / (math.sin(alpha_r) * math.sin(beta_r))
    val = min(1.0, max(-1.0, val))
    gamma_star = math.acos(val)
    vec_a = [a * math.sin(beta_r), 0.0, a * math.cos(beta_r)]
    vec_b = [-b * math.sin(alpha_r) * math.cos(gamma_star),
             b * math.sin(alpha_r) * math.sin(gamma_star),
             b * math.cos(alpha_r)]
    vec_c = [0.0, 0.0, float(c)]
    return np.array([vec_a, vec_b, vec_c], dtype=np.float64)


# ---------------------------------------------------------------------------
# symmetry operations
# ---------------------------------------------------------------------------


_SYMOP_TOKEN = re.compile(r"[+-]|\d+\.?\d*(?:/\d+\.?\d*)?|\.\d+|[xyz]")


def _parse_symop(op: str) -> tuple[np.ndarray, np.ndarray]:
    """``'-y+1/2, x-y, z'`` -> (rotation [3,3], translation [3])."""
    comps = op.lower().replace(" ", "").split(",")
    if len(comps) != 3:
        raise ValueError(f"bad symmetry op: {op!r}")
    rot = np.zeros((3, 3), np.float64)
    trans = np.zeros(3, np.float64)
    for row, comp in enumerate(comps):
        toks = _SYMOP_TOKEN.findall(comp)
        if "".join(toks) != comp:
            raise ValueError(f"bad symmetry op component: {comp!r}")
        sign, num = 1.0, None
        for tok in toks + ["+"]:  # trailing '+' flushes a pending constant
            if tok in "+-":
                if num is not None:
                    trans[row] += sign * num
                    num = None
                sign = 1.0 if tok == "+" else -1.0
            elif tok in "xyz":
                rot[row, "xyz".index(tok)] += sign * (
                    1.0 if num is None else num)
                num = None
                sign = 1.0
            else:
                if "/" in tok:
                    p, q = tok.split("/")
                    num = float(p) / float(q)
                else:
                    num = float(tok)
    return rot, trans


def _symops(loops) -> list[tuple[np.ndarray, np.ndarray]]:
    op_tags = ("_symmetry_equiv_pos_as_xyz",
               "_space_group_symop_operation_xyz")
    for cols in loops:
        for tag in op_tags:
            if tag in cols:
                return [_parse_symop(s) for s in cols[tag]]
    # no symmetry loop: identity only (P1 implied)
    return [(np.eye(3), np.zeros(3))]


# ---------------------------------------------------------------------------
# atom sites
# ---------------------------------------------------------------------------


_ELEM_RE = re.compile(r"^([A-Z][a-z]?)")


def _symbol_to_z(raw: str) -> int:
    """``'Fe2+'``/``'Si'``/label ``'O3'`` -> atomic number."""
    m = _ELEM_RE.match(raw.strip())
    if not m or m.group(1) not in SYMBOL_TO_Z:
        raise ValueError(f"unknown element symbol in CIF: {raw!r}")
    return SYMBOL_TO_Z[m.group(1)]


def parse_cif(text: str) -> dict:
    """CIF string -> ``{"numbers", "cart_coords", "lattice"}`` (the
    pre-parsed-structure dict ``structure_from_cif`` consumes).

    numbers [N] int64, cart_coords [N,3] f64 (angstrom), lattice [3,3] f64
    row vectors."""
    scalars, loops = _parse_document(text)

    try:
        cell = [_parse_number(scalars[k]) for k in (
            "_cell_length_a", "_cell_length_b", "_cell_length_c",
            "_cell_angle_alpha", "_cell_angle_beta", "_cell_angle_gamma")]
    except KeyError as e:
        raise ValueError(f"CIF missing cell parameter {e.args[0]}") from e
    if any(math.isnan(v) for v in cell):
        raise ValueError(f"CIF cell parameter unknown ('.'/'?'): {cell}")
    lattice = lattice_from_parameters(*cell)

    site_cols = None
    for cols in loops:
        if all(f"_atom_site_fract_{ax}" in cols for ax in "xyz"):
            site_cols = cols
            break
    if site_cols is None:
        raise ValueError("CIF has no _atom_site_fract_x/y/z loop")

    if "_atom_site_type_symbol" in site_cols:
        raw_syms = site_cols["_atom_site_type_symbol"]
    elif "_atom_site_label" in site_cols:
        raw_syms = site_cols["_atom_site_label"]
    else:
        raise ValueError("CIF atom loop has neither _atom_site_type_symbol "
                         "nor _atom_site_label")
    if "_atom_site_occupancy" in site_cols:
        for occ in site_cols["_atom_site_occupancy"]:
            o = _parse_number(occ)
            if not math.isnan(o) and o < 0.99:
                raise ValueError(
                    f"disordered CIF site (occupancy {o}) is unsupported — "
                    "the reference pipeline consumes ordered structures")

    frac = np.array(
        [[_parse_number(site_cols[f"_atom_site_fract_{ax}"][i])
          for ax in "xyz"] for i in range(len(raw_syms))], np.float64)
    numbers = np.array([_symbol_to_z(s) for s in raw_syms], np.int64)

    # symmetry expansion + dedup on the fractional grid (mod 1); tolerance
    # 1e-4 in fractional units ~ the precision CIF files are written with
    ops = _symops(loops)

    def same_site(g, h):
        d = np.abs(g - h)
        return bool(np.all(np.minimum(d, 1.0 - d) < 1e-4))  # circular dist

    out_z: list[int] = []
    out_f: list[np.ndarray] = []
    for z, f in zip(numbers, frac):
        images: list[np.ndarray] = []
        for rot, trans in ops:
            g = (rot @ f + trans) % 1.0
            g = np.where(g > 1.0 - 1e-4, 0.0, g)  # 0.9999.. == 0
            if not any(same_site(g, h) for h in images):
                images.append(g)
        for g in images:
            out_z.append(int(z))
            out_f.append(g)

    frac_all = np.array(out_f, np.float64).reshape(-1, 3)
    return {
        "numbers": np.array(out_z, np.int64),
        "cart_coords": frac_all @ lattice,
        "lattice": lattice,
    }
