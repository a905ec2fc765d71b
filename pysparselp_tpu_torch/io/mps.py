# Verbatim copy of pysparselp_tpu/io/mps.py (tests/test_torch_slice.py holds the two equal).
"""MPS problem reader / writer and perPlex certified-solution reader.

Capability parity with the reference's ``pysparselp/MPSparser.py:10-271``
(fixed-column MPS: ROWS N/L/G/E, COLUMNS, RHS, BOUNDS UP/LO/FR/FX/MI/PL)
and ``save_mps``.  Two extensions go *beyond* the reference: RANGES
(reference raises at ``MPSparser.py:70-72``) and integer declarations —
BOUNDS BV/LI/UI and COLUMNS INTORG/INTEND markers (reference raises at
``MPSparser.py:173-175``), whose integrality mask feeds
``SparseLP.is_integer`` and the ``integer/`` rounding + propagation
machinery.  RANGES semantics: an L row with rhs
``b`` and range ``R`` becomes ``b-|R| <= ax <= b``, a G row ``b <= ax <=
b+|R|``, and an E row becomes a two-sided inequality ``[b, b+R]`` (R>0) or
``[b+R, b]`` (R<0); zero-range E rows stay equalities.  This matches the
standard MPS convention (lp_solve / CPLEX documentation).
(``pysparselp/SparseLP.py:280-366``, whose writer is broken there — typo
``a_eq.ruse_preconditioning`` at ``SparseLP.py:310`` — and fixed here).

perPlex solution files (exact rational LP solutions,
https://opus4.kobv.de/opus4-zib/files/727/ZR-03-05.pdf) provide the ground
truth for the netlib golden-curve tests.
"""

from __future__ import annotations

import numpy as np
from scipy import sparse


def _fields(line):
    """Fixed-column MPS tokenizer: standard fields 1-6."""
    line = line.rstrip("\n")
    return [
        line[1:3].strip(),
        line[4:12].ljust(8),
        line[14:22].ljust(8),
        line[24:36].strip(),
        line[39:47].ljust(8),
        line[49:61].strip(),
    ]


def mps_parser(f, fsol=None):
    """Parse an MPS file (and optional perPlex solution file).

    Returns a dict with ``cost_vector, lower_bounds, upper_bounds, a_eq, b_eq,
    a_ineq, b_lower, b_upper, problem_name, costname, solution`` — the same
    contract as the reference parser (``MPSparser.py:194-205``).
    """
    nb_ineq = nb_eq = nb_var = 0
    b_lower, b_upper, b_eq = {}, {}, {}
    rows, variables, v_id_to_var = {}, {}, {}
    a_ineq_list, a_eq_list = [], []
    ranges = {}
    problem_name = costname = None
    section = None
    in_integer_block = False

    for raw in f:
        line = raw.rstrip("\n")
        if line.startswith("ENDATA"):
            break
        if not line or line.startswith("*"):
            continue
        if line.startswith("NAME"):
            problem_name = line[14:].strip() or line.split()[-1]
            continue
        if line.startswith(("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS")):
            section = line.split()[0]
            continue
        t = _fields(line)

        if section == "ROWS":
            rtype = t[0]
            rname = t[1]
            if rname in rows:
                raise ValueError(f"duplicate row {rname!r}")
            r = {"type": rtype}
            rows[rname] = r
            if rtype == "N":
                costname = rname
            elif rtype == "G":
                r["id"] = nb_ineq
                b_lower[nb_ineq] = 0.0
                b_upper[nb_ineq] = np.inf
                nb_ineq += 1
            elif rtype == "L":
                r["id"] = nb_ineq
                b_lower[nb_ineq] = -np.inf
                b_upper[nb_ineq] = 0.0
                nb_ineq += 1
            elif rtype == "E":
                r["id"] = nb_eq
                b_eq[nb_eq] = 0.0
                nb_eq += 1

        elif section == "COLUMNS":
            if "'MARKER'" in line:
                # INTORG/INTEND markers bracket integer columns (the
                # standard MIP declaration; the reference's parser has no
                # integer support at all, MPSparser.py:173-175)
                if "'INTORG'" in line:
                    in_integer_block = True
                elif "'INTEND'" in line:
                    in_integer_block = False
                else:
                    raise ValueError(f"unknown MARKER line: {line!r}")
                continue
            vname = t[1]
            if vname in variables:
                var = variables[vname]
            else:
                # default MPS bounds: x >= 0, no upper bound
                var = {"id": nb_var, "UP": np.inf, "LO": 0.0, "cost": 0.0,
                       "INT": in_integer_block}
                variables[vname] = var
                v_id_to_var[nb_var] = var
                nb_var += 1
            j = var["id"]
            for k in range(2):
                rname, sval = t[2 + 2 * k], t[3 + 2 * k]
                if not rname.strip() or not sval:
                    break
                r = rows[rname]
                v = float(sval)
                if r["type"] == "N":
                    var["cost"] = v
                elif r["type"] in ("L", "G"):
                    a_ineq_list.append((r["id"], j, v))
                elif r["type"] == "E":
                    a_eq_list.append((r["id"], j, v))

        elif section == "RHS":
            for k in range(2):
                rname, sval = t[2 + 2 * k], t[3 + 2 * k]
                if not rname.strip() or not sval:
                    break
                r = rows[rname]
                v = float(sval)
                if r["type"] == "N":
                    raise ValueError("RHS entry on the objective row")
                elif r["type"] == "L":
                    b_upper[r["id"]] = v
                elif r["type"] == "G":
                    b_lower[r["id"]] = v
                elif r["type"] == "E":
                    b_eq[r["id"]] = v

        elif section == "RANGES":
            for k in range(2):
                rname, sval = t[2 + 2 * k], t[3 + 2 * k]
                if not rname.strip() or not sval:
                    break
                if rows[rname]["type"] == "N":
                    raise ValueError("RANGES entry on the objective row")
                ranges[rname] = float(sval)

        elif section == "BOUNDS":
            btype = line[1:3].strip()
            vname = t[2]
            var = variables[vname]
            var["name"] = vname
            if btype in ("UP", "LO"):
                var[btype] = float(t[3])
            elif btype == "FR":
                var["UP"], var["LO"] = np.inf, -np.inf
            elif btype == "FX":
                var["UP"] = var["LO"] = float(t[3])
            elif btype == "MI":
                var["LO"] = -np.inf
            elif btype == "PL":
                var["UP"] = np.inf
            # integer bound types (BEYOND the reference, which raises at
            # MPSparser.py:173-175): the integrality flag feeds
            # SparseLP.is_integer -> force_integer solves and the
            # integer/{rounding,propagation} machinery
            elif btype == "BV":
                var["UP"], var["LO"], var["INT"] = 1.0, 0.0, True
            elif btype == "LI":
                var["LO"], var["INT"] = float(t[3]), True
            elif btype == "UI":
                var["UP"], var["INT"] = float(t[3]), True

    if ranges:
        # L/G rows just tighten the open side of the existing two-sided row;
        # E rows with a nonzero range become two-sided inequality rows, so
        # their entries move from a_eq to a_ineq and the remaining equality
        # row ids are compacted.
        eq_to_ineq = {}
        for rname, rng in ranges.items():
            r = rows[rname]
            i = r["id"]
            if r["type"] == "L":
                b_lower[i] = b_upper[i] - abs(rng)
            elif r["type"] == "G":
                b_upper[i] = b_lower[i] + abs(rng)
            elif r["type"] == "E" and rng != 0.0:
                new_id = nb_ineq
                nb_ineq += 1
                eq_to_ineq[i] = new_id
                rhs = b_eq[i]
                if rng > 0:
                    b_lower[new_id], b_upper[new_id] = rhs, rhs + rng
                else:
                    b_lower[new_id], b_upper[new_id] = rhs + rng, rhs
        if eq_to_ineq:
            kept = [i for i in range(nb_eq) if i not in eq_to_ineq]
            eq_remap = {old: new for new, old in enumerate(kept)}
            new_eq_list = []
            for i, j, v in a_eq_list:
                if i in eq_to_ineq:
                    a_ineq_list.append((eq_to_ineq[i], j, v))
                else:
                    new_eq_list.append((eq_remap[i], j, v))
            a_eq_list = new_eq_list
            b_eq = {eq_remap[i]: b_eq[i] for i in kept}
            nb_eq = len(kept)

    cost_vector = np.array([v_id_to_var[i]["cost"] for i in range(nb_var)])
    upper_bounds = np.array([v_id_to_var[i]["UP"] for i in range(nb_var)])
    lower_bounds = np.array([v_id_to_var[i]["LO"] for i in range(nb_var)])

    def coo(entries, m):
        if entries:
            i, j, v = zip(*entries)
        else:
            i = j = v = []
        return sparse.coo_matrix((v, (i, j)), shape=(m, nb_var)).tocsr()

    result = {
        "cost_vector": cost_vector,
        "upper_bounds": upper_bounds,
        "lower_bounds": lower_bounds,
        "is_integer": np.array([bool(v_id_to_var[i].get("INT", False))
                                for i in range(nb_var)]),
        "a_eq": coo(a_eq_list, nb_eq),
        "b_eq": np.array([b_eq[i] for i in range(nb_eq)]),
        "a_ineq": coo(a_ineq_list, nb_ineq),
        "b_lower": np.array([b_lower[i] for i in range(nb_ineq)]),
        "b_upper": np.array([b_upper[i] for i in range(nb_ineq)]),
        "problem_name": problem_name,
        "costname": costname,
        "solution": None,
    }

    if fsol is not None:
        result["solution"] = parse_perplex_solution(fsol, variables, nb_var,
                                                    v_id_to_var)
    return result


def to_sparse_lp(d):
    """Build a :class:`~pysparselp_tpu.SparseLP` from a ``mps_parser``
    dict — bounds, costs, both constraint systems, and the integrality
    mask (so ``lp.solve(force_integer=True)`` and the
    ``integer``-package tools apply directly)."""
    from ..modeling import SparseLP

    lp = SparseLP()
    lp.add_variables_array(
        d["cost_vector"].size, lower_bounds=d["lower_bounds"],
        upper_bounds=d["upper_bounds"], costs=d["cost_vector"],
        is_integer=d.get("is_integer", False))
    if d["a_eq"].shape[0]:
        lp.add_equality_constraints_sparse(d["a_eq"], d["b_eq"])
    if d["a_ineq"].shape[0]:
        lp.add_inequality_constraints_sparse(d["a_ineq"], d["b_lower"],
                                             d["b_upper"])
    return lp


def parse_perplex_solution(fsol, variables, nb_var, v_id_to_var):
    """Parse a perPlex exact-solution file (``MPSparser.py:207-269``).

    Variable values are exact rationals ``p/q``; 'on lower/upper/both' states
    take the value from the MPS bounds.
    """
    section = None
    var = None
    for raw in fsol:
        line = raw.rstrip("\n")
        if line.startswith("- EOF"):
            break
        if line.startswith("- Variables"):
            section = "Variables"
            continue
        if line.startswith("- Constraints"):
            section = "Constraints"
            continue
        if section != "Variables":
            continue
        if line.startswith("V Name"):
            name = line.split(": ")[1].ljust(8)
            var = variables[name]
        elif line.startswith("V Value") and var is not None:
            val1 = float(line.split(":")[1].split("=")[0])
            frac = line.split(":")[1].split("=")[1].split("/")
            if len(frac) == 1:
                val = float(frac[0])
            else:
                val = float(frac[0]) / float(frac[1])
            var["sol"] = val1 if np.isnan(val) else val
        elif line.startswith("V State    : on lower") and var is not None:
            var["sol"] = var["LO"]
        elif line.startswith("V State    : on upper") and var is not None:
            var["sol"] = var["UP"]
        elif line.startswith("V State    : on both") and var is not None:
            var["sol"] = var["UP"]
    return np.array([v_id_to_var[i].get("sol", v_id_to_var[i]["LO"])
                     for i in range(nb_var)])


def save_mps(lp, filename):
    """Write the model as a (one-sided) MPS file.

    Working version of the reference's broken writer
    (``SparseLP.py:280-366``): requires ``b_lower is None`` (call
    ``convert_to_one_sided_inequality_system`` first).
    """
    if lp.b_lower is not None and np.asarray(lp.b_lower).size:
        raise ValueError(
            "save_mps needs a one-sided inequality system; call "
            "convert_to_one_sided_inequality_system() first"
        )
    def _num(v):
        s = "%.12g" % v
        return s if len(s) <= 12 else "%.4e" % v

    def _entry(f, name, row, v):
        # fixed columns: field2 @ 5-12, field3 @ 15-22, field4 @ 25-36
        f.write("    %-10s%-10s%s\n" % (name, row, _num(v)))

    a_eq = lp.a_equalities.tocsr().tocsc().tocoo() if lp.a_equalities is not None else None
    a_ineq = lp.a_inequalities.tocsr().tocsc().tocoo() if lp.a_inequalities is not None else None
    n_eq = a_eq.shape[0] if a_eq is not None else 0
    n_ineq = a_ineq.shape[0] if a_ineq is not None else 0

    with open(filename, "w") as f:
        f.write("NAME          exportedFromPython\n")
        f.write("ROWS\n")
        f.write(" N  OBJ\n")
        for i in range(n_eq):
            f.write(f" E  E{i}\n")
        for i in range(n_ineq):
            f.write(f" L  I{i}\n")
        f.write("COLUMNS\n")
        k_eq = k_ineq = 0
        eq_entries = len(a_eq.col) if a_eq is not None else 0
        ineq_entries = len(a_ineq.col) if a_ineq is not None else 0
        for j in range(lp.nb_variables):
            _entry(f, "X%d" % j, "OBJ", lp.costsvector[j])
            while k_eq < eq_entries and a_eq.col[k_eq] == j:
                _entry(f, "X%d" % j, "E%d" % a_eq.row[k_eq], a_eq.data[k_eq])
                k_eq += 1
            while k_ineq < ineq_entries and a_ineq.col[k_ineq] == j:
                _entry(f, "X%d" % j, "I%d" % a_ineq.row[k_ineq],
                       a_ineq.data[k_ineq])
                k_ineq += 1
        f.write("RHS\n")
        for i in range(n_eq):
            _entry(f, "RHS0", "E%d" % i, lp.b_equalities[i])
        for i in range(n_ineq):
            _entry(f, "RHS0", "I%d" % i, lp.b_upper[i])
        f.write("BOUNDS\n")
        for j in range(lp.nb_variables):
            lo, up = lp.lower_bounds[j], lp.upper_bounds[j]
            if np.isinf(lo) and np.isinf(up):
                f.write(" FR BOUND     X%d\n" % j)
                continue
            if not np.isinf(lo):
                f.write(" LO %-10sX%-9d%s\n" % ("BOUND", j, _num(lo)))
            else:
                f.write(" MI BOUND     X%d\n" % j)
            if not np.isinf(up):
                f.write(" UP %-10sX%-9d%s\n" % ("BOUND", j, _num(up)))
        f.write("ENDATA\n")
