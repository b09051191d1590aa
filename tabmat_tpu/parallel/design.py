"""DeviceDesign: any MatrixBase as a jit-compatible functional pytree.

The class layer (``tabmat_tpu.models``) is host-driven: each op is its own
device dispatch.  For training loops (IRLS, coordinate descent) we want the
WHOLE step — matvec, weighting, transpose-matvec, CG — inside one jitted XLA
program.  ``DeviceDesign.from_matrix`` converts DenseMatrix / SparseMatrix /
CategoricalMatrix / SplitMatrix / StandardizedMatrix into a pytree of device
arrays + static structure, exposing traceable ``@`` and ``.T @`` so
``tabmat_tpu.glm.irls_step`` works on it unchanged.

Block math (scatter-free, sharding-friendly — rows may shard over 'dp'):
- dense:        contraction at pinned full precision
- sparse:       CSR/CSC boundary-segmented cumsums
- categorical:  gather / SegmentPlan cumsum
- standardized: inner ops + rank-1 shift/mult corrections
"""

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import dense_ops, sparse_ops


class _Block:
    """One column block: static descriptor + device arrays."""

    def __init__(
        self, kind: str, arrays: dict, width: int, positions: np.ndarray, meta=()
    ):
        self.kind = kind
        self.arrays = arrays
        self.width = width
        self.positions = positions  # global column indices (host numpy)
        self.meta = meta  # static per-kind extras (e.g. per-cat widths)


def _stack_categoricals(cat_pairs, n_rows: int) -> _Block:
    """Merge several categorical blocks into ONE flat pseudo-categorical.

    Per-iteration kernel-launch count then stays constant in the number of
    categorical blocks:

    - matvec: one padded gather over stacked codes (invalid codes point at
      the zero pad), reshaped (C, n) and summed;
    - tmv: one gather through the concatenated per-cat sort permutations,
      one global cumsum (prefix offsets cancel in the boundary differences),
      one start/end boundary gather.
    """
    codes_parts, perm_parts, starts_parts, ends_parts, pos_parts = [], [], [], [], []
    local_off = 0
    flat_off = 0
    total_width = sum(m.shape[1] for m, _ in cat_pairs)
    for m, positions in cat_pairs:
        eff = m._eff_codes_np
        codes_parts.append(
            np.where(eff >= 0, eff + local_off, total_width).astype(np.int32)
        )
        plan = m.plan
        perm_parts.append(np.asarray(plan.perm, dtype=np.int64))
        bounds = np.asarray(plan.bounds, dtype=np.int64) + flat_off
        starts_parts.append(bounds[:-1])
        ends_parts.append(bounds[1:])
        pos_parts.append(np.asarray(positions))
        local_off += m.shape[1]
        flat_off += m.shape[0]

    arrays = {
        "codes": jnp.asarray(np.concatenate(codes_parts)),
        "perm": jnp.asarray(np.concatenate(perm_parts)),
        "starts": jnp.asarray(np.concatenate(starts_parts)),
        "ends": jnp.asarray(np.concatenate(ends_parts)),
    }
    # cross-pair plans for the explicit design sandwich (built when the
    # product of widths is bounded — the same feasibility as the sandwich)
    widths = tuple(m.shape[1] for m, _ in cat_pairs)
    if all(
        w1 * w2 <= (1 << 24)
        for a, w1 in enumerate(widths)
        for w2 in widths[a + 1 :]
    ):
        from .. import _native

        for a in range(len(cat_pairs)):
            for b in range(a + 1, len(cat_pairs)):
                e1 = cat_pairs[a][0]._eff_codes_np.astype(np.int32, copy=False)
                e2 = cat_pairs[b][0]._eff_codes_np.astype(np.int32, copy=False)
                combined = _native.combine_codes(e1, e2, widths[b])
                perm, bounds = _native.counting_argsort(
                    np.asarray(combined, dtype=np.int32), widths[a] * widths[b]
                )
                arrays[f"xperm_{a}_{b}"] = jnp.asarray(perm)
                arrays[f"xbounds_{a}_{b}"] = jnp.asarray(bounds)
    return _Block(
        "catstack",
        arrays,
        total_width,
        np.concatenate(pos_parts),
        meta=(widths,),
    )


# sparse×cat cross plans past this many combined segments are skipped
# (the bounds array alone is 8 bytes/segment; same cap as cat×cat)
SPARSE_CAT_MAX_SEGMENTS = 1 << 24


def _attach_sparse_cat_plans(block: _Block, m, cat_units) -> None:
    """Structural sparse×categorical cross-sandwich plans onto ``block``.

    For cat unit ``ci`` the cross block is ``out[c, j] = Σ_{nnz (r, j)}
    data · w[r]`` over rows with ``code[r] == c`` — one bounded segment
    sum over the nnz keyed by ``code·k_s + col`` (invalid codes land in a
    sentinel tail segment that the stored bounds exclude).  Everything but
    the ``w`` gather is pre-sorted at build time, mirroring the
    pair-expansion sandwich plan (reference cross walker:
    ``tabmat/ext/split.pyx`` cat×sparse path).
    """
    from .. import _native

    csc = m._array
    ks = m.shape[1]
    counts = np.diff(csc.indptr)
    cols = np.repeat(np.arange(ks, dtype=np.int64), counts)
    rows = np.asarray(csc.indices)
    for ci, (codes, wc) in enumerate(cat_units):
        n_seg = wc * ks
        if n_seg > SPARSE_CAT_MAX_SEGMENTS:
            continue
        c = codes[rows].astype(np.int64)
        key = np.where(c >= 0, c * ks + cols, n_seg)
        perm, bounds = _native.counting_argsort(
            key.astype(np.int32), n_seg + 1
        )
        block.arrays[f"xs{ci}_prod"] = jnp.asarray(np.asarray(csc.data)[perm])
        block.arrays[f"xs{ci}_rows"] = jnp.asarray(
            rows[perm].astype(np.int32, copy=False)
        )
        block.arrays[f"xs{ci}_bounds"] = jnp.asarray(
            np.asarray(bounds[: n_seg + 1], dtype=np.int64)
        )


class DeviceDesign:
    """A traceable linear operator assembled from matrix blocks."""

    def __init__(self, blocks, n_rows: int, n_cols: int, shift=None, mult=None,
                 index_map=None):
        self.blocks = blocks
        self.shape = (n_rows, n_cols)
        self.shift = shift  # standardization: x -> mult*x + shift (per col)
        self.mult = mult
        # gather map placing concat(block outputs) into global column order
        if index_map is None:
            index_map = np.concatenate([b.positions for b in blocks])
            index_map = np.argsort(index_map, kind="stable")
        self._index_map = jnp.asarray(np.asarray(index_map, dtype=np.int32))
        # inverse: global order -> concat order (for splitting v by block)
        order = np.concatenate([b.positions for b in blocks])
        self._gather_v = jnp.asarray(np.asarray(order, dtype=np.int32))
        # blocks laid out in global column order (every from_df/benchmark
        # design): the placement gathers are identities — skip them
        self._identity_order = bool(
            np.array_equal(np.asarray(index_map), np.arange(n_cols))
        )

    def astype_float(self, dtype):
        """A view of the design with float leaves cast (ints untouched).

        Used for the mixed-precision inner CG: gathers/cumsums in f32 halve
        the traffic, while the outer gradient stays f64.
        """
        if jnp.dtype(dtype) == jnp.float64:
            new_blocks = self.blocks
        else:
            new_blocks = [
                _Block(
                    b.kind,
                    {
                        k: v.astype(dtype)
                        if jnp.issubdtype(v.dtype, jnp.floating)
                        else v
                        for k, v in b.arrays.items()
                    },
                    b.width,
                    b.positions,
                    meta=b.meta,
                )
                for b in self.blocks
            ]
        d = object.__new__(DeviceDesign)
        d.blocks = new_blocks
        d.shape = self.shape
        cast = lambda x: (  # noqa: E731
            None if x is None else x.astype(dtype)
            if jnp.issubdtype(x.dtype, jnp.floating) else x
        )
        d.shift = cast(self.shift)
        d.mult = cast(self.mult)
        d._index_map = self._index_map
        d._gather_v = self._gather_v
        d._identity_order = self._identity_order
        return d

    def shard(self, mesh, rows: str = "dp", dense_cols: str = None):
        """Place the design's leaves on a device mesh — the user multichip path.

        Everything row-indexed shards over the ``rows`` mesh axis (or an axis
        tuple); dense design columns optionally shard over ``dense_cols``;
        small structural state replicates.  XLA turns the reductions into
        per-shard partials + an all-reduce across the devices (explicit
        shard_map variants live in ``parallel.shard_ops``).

        The result feeds ``glm.irls_step``/``fit_glm`` unchanged: the step
        jit-compiles against the leaf shardings inside ``with mesh:``.
        """
        from jax.sharding import NamedSharding, PartitionSpec as P

        rows_spec = rows if isinstance(rows, tuple) else (rows,)
        n_row_shards = int(np.prod([mesh.shape[a] for a in rows_spec]))

        def put(x, *spec):
            return jax.device_put(x, NamedSharding(mesh, P(*spec)))

        def rowdim(x, *tail):
            return put(x, rows_spec, *tail)

        new_blocks = []
        for b in self.blocks:
            arrs = {}
            for key, v in b.arrays.items():
                if b.kind == "dense":
                    arrs[key] = rowdim(v, dense_cols)
                elif b.kind == "sparse":
                    # nnz-indexed leaves do not align with row shards;
                    # replicate (CSR/CSC cumsums stay local per device)
                    arrs[key] = put(v)
                elif key in ("codes", "perm") and v.shape[0] % n_row_shards == 0:
                    arrs[key] = rowdim(v)
                else:
                    arrs[key] = put(v)
            new_blocks.append(_Block(b.kind, arrs, b.width, b.positions, b.meta))

        d = object.__new__(DeviceDesign)
        d.blocks = new_blocks
        d.shape = self.shape
        d.shift = None if self.shift is None else put(self.shift)
        d.mult = None if self.mult is None else put(self.mult)
        d._index_map = put(self._index_map)
        d._gather_v = put(self._gather_v)
        d._identity_order = self._identity_order
        return d

    @property
    def dtype(self):
        """Float dtype of the design (from the first float-valued block)."""
        for b in self.blocks:
            for key in ("X", "csr_data"):
                if key in b.arrays:
                    return b.arrays[key].dtype
        return jnp.float64

    # -- conversion ------------------------------------------------------

    @classmethod
    def from_matrix(cls, mat) -> "DeviceDesign":
        """Convert any MatrixBase / StandardizedMatrix to a DeviceDesign."""
        from ..models.categorical import CategoricalMatrix
        from ..models.dense import DenseMatrix
        from ..models.sparse import SparseMatrix
        from ..models.split import SplitMatrix
        from ..models.standardized import StandardizedMatrix

        if isinstance(mat, StandardizedMatrix):
            inner = cls.from_matrix(mat.mat)
            inner.shift = jnp.asarray(mat.shift)
            inner.mult = None if mat.mult is None else jnp.asarray(mat.mult)
            return inner

        def block_of(m, positions) -> _Block:
            if isinstance(m, DenseMatrix):
                return _Block("dense", {"X": m.unpack()}, m.shape[1], positions)
            if isinstance(m, SparseMatrix):
                data_r, cols_r, bounds_r = m._csr_parts()
                data_c, rows_c, bounds_c = m._csc_parts()
                arrays = {
                    "csr_data": data_r, "csr_cols": cols_r, "csr_bounds": bounds_r,
                    "csc_data": data_c, "csc_rows": rows_c, "csc_bounds": bounds_c,
                }
                # pair-expansion plan for the explicit design sandwich
                # (None when over budget — supports_sandwich then gates)
                pp = m._pair_sandwich_parts()
                if pp is not None:
                    arrays["pp_prod"], arrays["pp_rows"], arrays["pp_bounds"] = pp
                return _Block("sparse", arrays, m.shape[1], positions)
            if isinstance(m, CategoricalMatrix):
                plan = m.plan
                arrays = {
                    "codes": m.eff_codes, "perm": plan.perm, "bounds": plan.bounds,
                }
                return _Block("cat", arrays, m.shape[1], positions)
            raise TypeError(f"Cannot convert {type(m).__name__} to a DeviceDesign")

        if isinstance(mat, SplitMatrix):
            pairs = list(zip(mat.matrices, mat.indices))
            cat_pairs = [(m, i) for m, i in pairs if isinstance(m, CategoricalMatrix)]
            other_pairs = [
                (m, i) for m, i in pairs if not isinstance(m, CategoricalMatrix)
            ]
            blocks = []
            sparse_kind = []  # (block, matrix) needing cat cross plans
            for m, idx in other_pairs:
                b = block_of(m, idx)
                if b.kind == "sparse":
                    sparse_kind.append((b, m))
                blocks.append(b)
            if len(cat_pairs) > 1:
                blocks.append(_stack_categoricals(cat_pairs, mat.shape[0]))
            else:
                blocks.extend(block_of(m, idx) for m, idx in cat_pairs)
            if sparse_kind and cat_pairs:
                cat_units = [
                    (m._eff_codes_np, m.shape[1]) for m, _ in cat_pairs
                ]
                for b, m in sparse_kind:
                    _attach_sparse_cat_plans(b, m, cat_units)
            return cls(blocks, mat.shape[0], mat.shape[1])
        blocks = [block_of(mat, np.arange(mat.shape[1]))]
        return cls(blocks, mat.shape[0], mat.shape[1])

    # -- traceable ops ------------------------------------------------------

    def _block_matvec(self, block: _Block, v: jax.Array) -> jax.Array:
        a = block.arrays
        if block.kind == "dense":
            return dense_ops.matmul(a["X"], v)
        if block.kind == "sparse":
            t = a["csr_data"] * jnp.take(v, a["csr_cols"])
            csum = jnp.cumsum(t)
            p = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
            return jnp.take(p, a["csr_bounds"][1:]) - jnp.take(p, a["csr_bounds"][:-1])
        if block.kind == "catstack":
            # stacked cats: one padded gather, reshape (C, n), one reduce
            vcp = jnp.concatenate([v, jnp.zeros((1,), v.dtype)])
            g = jnp.take(vcp, a["codes"])
            return g.reshape(-1, self.shape[0]).sum(axis=0)
        # categorical: gather (negative codes contribute zero)
        codes = a["codes"]
        valid = codes >= 0
        g = jnp.take(v, jnp.clip(codes, 0, block.width - 1))
        return jnp.where(valid, g, jnp.zeros((), g.dtype))

    def _block_tmv(self, block: _Block, r: jax.Array) -> jax.Array:
        a = block.arrays
        if block.kind == "dense":
            return dense_ops.transpose_matvec(a["X"], r)
        if block.kind == "sparse":
            t = a["csc_data"] * jnp.take(r, a["csc_rows"])
            csum = jnp.cumsum(t)
            p = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
            return jnp.take(p, a["csc_bounds"][1:]) - jnp.take(p, a["csc_bounds"][:-1])
        if block.kind == "catstack":
            # one gather through all cats' perms, one global cumsum (prefix
            # offsets cancel in the start/end differences), one boundary take
            g = jnp.take(r, a["perm"])
            csum = jnp.cumsum(g)
            p = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
            return jnp.take(p, a["ends"]) - jnp.take(p, a["starts"])
        g = jnp.take(r, a["perm"])
        csum = jnp.cumsum(g)
        p = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
        return jnp.take(p, a["bounds"][1:]) - jnp.take(p, a["bounds"][:-1])

    def matvec(self, v: jax.Array) -> jax.Array:
        """``X @ v`` (traceable)."""
        v_eff = v * self.mult if self.mult is not None else v
        v_blocks = v_eff if self._identity_order else jnp.take(v_eff, self._gather_v)
        out = jnp.zeros(self.shape[0], dtype=v_eff.dtype)
        off = 0
        for b in self.blocks:
            out = out + self._block_matvec(b, v_blocks[off : off + b.width])
            off += b.width
        if self.shift is not None:
            out = out + dense_ops.matmul(self.shift, v)
        return out

    def transpose_matvec(self, r: jax.Array) -> jax.Array:
        """``X.T @ r`` (traceable)."""
        segs = [self._block_tmv(b, r) for b in self.blocks]
        flat = jnp.concatenate(segs)
        out = flat if self._identity_order else jnp.take(flat, self._index_map)
        if self.mult is not None:
            out = out * self.mult
        if self.shift is not None:
            out = out + self.shift * jnp.sum(r)
        return out

    # -- explicit sandwich (traceable) --------------------------------------

    # widest design for which the explicit (k, k) Hessian is built
    SANDWICH_MAX_COLS = 4096

    @property
    def supports_sandwich(self) -> bool:
        """True when a traceable explicit sandwich is available (static)."""
        if self.shape[1] > self.SANDWICH_MAX_COLS:
            return False
        if self.shift is not None or self.mult is not None:
            return False  # standardized designs use the hvp path
        kinds = {b.kind for b in self.blocks}
        if not kinds <= {"dense", "cat", "catstack", "sparse"}:
            return False
        if sum(b.kind == "dense" for b in self.blocks) > 1:
            return False  # explicit assembly assumes a single dense block
        sparse_blocks = [b for b in self.blocks if b.kind == "sparse"]
        if len(sparse_blocks) > 1:
            return False  # no sparse×sparse cross plan between distinct blocks
        n_cat_units = sum(
            1 if b.kind == "cat" else len(b.meta[0]) if b.kind == "catstack" else 0
            for b in self.blocks
        )
        for b in sparse_blocks:
            if "pp_prod" not in b.arrays:
                return False  # pair-expansion plan over budget
            if any(f"xs{ci}_prod" not in b.arrays for ci in range(n_cat_units)):
                return False  # a sparse×cat cross plan is missing
        for b in self.blocks:
            if b.kind == "catstack":
                widths = b.meta[0]
                for a in range(len(widths)):
                    for c in range(a + 1, len(widths)):
                        if f"xperm_{a}_{c}" not in b.arrays:
                            return False
        return True

    def sandwich(self, w: jax.Array) -> jax.Array:
        """Explicit ``Xᵀ diag(w) X`` → (k, k), one traceable expression.

        The classic GLM pattern the reference library exists for
        (``tabmat/split_matrix.py:324-356``), fused on device: per-unit
        diagonal blocks, pairwise cross blocks via segment reductions, and
        scatter-free assembly with the global column gather map.  Units are
        the blocks with categorical stacks expanded per sub-cat; the grid
        covers dense×sparse×categorical mixes (the primary ``from_df``
        output shape) in one traceable program with no host assembly.
        """

        def seg_sum(perm, starts, ends, vals):
            csum = jnp.cumsum(jnp.take(vals, perm))
            p = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
            return jnp.take(p, ends) - jnp.take(p, starts)

        def bounded(vals, bounds):
            csum = jnp.cumsum(vals)
            p = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum])
            return jnp.take(p, bounds[1:]) - jnp.take(p, bounds[:-1])

        n = self.shape[0]

        # --- expand blocks into units (unit order == column concat order).
        # cat info = (perm, starts, ends, width, ci) with ci the
        # global cat ordinal keying the sparse blocks' xs{ci}_* cross plans
        units = []
        cross = {}  # (unit_i, unit_j) -> same-stack cat×cat plan
        ci_counter = 0
        for b in self.blocks:
            if b.kind == "dense":
                units.append(("dense", b, None))
            elif b.kind == "sparse":
                units.append(("sparse", b, None))
            elif b.kind == "cat":
                bounds = b.arrays["bounds"]
                units.append(
                    ("cat", b,
                     (b.arrays["perm"], bounds[:-1], bounds[1:], b.width,
                      ci_counter))
                )
                ci_counter += 1
            else:  # catstack
                (widths,) = b.meta
                base = len(units)
                off_flat = 0
                start_off = 0
                for wc in widths:
                    # the stored starts/ends carry the flat c·n stream offset
                    # (for the stacked tmv); remove it for per-cat use
                    units.append(
                        ("cat", b,
                         (b.arrays["perm"][off_flat : off_flat + n],
                          b.arrays["starts"][start_off : start_off + wc] - off_flat,
                          b.arrays["ends"][start_off : start_off + wc] - off_flat,
                          wc,
                          ci_counter))
                    )
                    ci_counter += 1
                    off_flat += n
                    start_off += wc
                for a in range(len(widths)):
                    for c in range(a + 1, len(widths)):
                        cross[(base + a, base + c)] = (
                            b.arrays[f"xperm_{a}_{c}"],
                            b.arrays[f"xbounds_{a}_{c}"],
                        )

        # --- shared dense precompute -------------------------------------
        dense_units = [i for i, u in enumerate(units) if u[0] == "dense"]
        Xd = units[dense_units[0]][1].arrays["X"] if dense_units else None
        kd = Xd.shape[1] if Xd is not None else 0
        wXd = Xd * w[:, None] if Xd is not None else None

        # --- per-cell computations ---------------------------------------

        def cat_diag(info):
            perm, starts, ends, _, _ = info
            return jnp.diag(seg_sum(perm, starts, ends, w))

        def sparse_diag(b):
            a = b.arrays
            flat = bounded(
                a["pp_prod"] * jnp.take(w, a["pp_rows"]), a["pp_bounds"]
            )
            return flat.reshape(b.width, b.width)

        def dense_cat_cell(info):
            """(wc, kd) cat×dense cross: segment-sum of w-scaled dense rows."""
            perm, starts, ends, _, _ = info
            g = jnp.take(wXd, perm, axis=0)
            csum = jnp.cumsum(g, axis=0)
            p = jnp.concatenate([jnp.zeros((1, kd), csum.dtype), csum], axis=0)
            return jnp.take(p, ends, axis=0) - jnp.take(p, starts, axis=0)

        def sparse_dense_cell(b):
            """(ks, kd) sparse×dense cross — CSC gather + bounded segsum."""
            a = b.arrays
            return sparse_ops.csc_cross_dense(
                a["csc_data"], a["csc_rows"], a["csc_bounds"], w, Xd
            )

        def sparse_cat_cell(b, info):
            """(wc, ks) cat×sparse cross from the combined-key nnz plan."""
            wc, ci = info[3], info[4]
            a = b.arrays
            vals = a[f"xs{ci}_prod"] * jnp.take(w, a[f"xs{ci}_rows"])
            flat = bounded(vals, a[f"xs{ci}_bounds"])
            return flat.reshape(wc, b.width)

        def cat_cat_cell(i, j, info_i, info_j):
            """(wi, wj) for same-stack cat units i < j."""
            if (i, j) not in cross:
                raise NotImplementedError("missing cross plan")
            wi, wj = info_i[3], info_j[3]
            xperm, xbounds = cross[(i, j)]
            flat = seg_sum(xperm, xbounds[:-1], xbounds[1:], w)
            return flat.reshape(wi, wj)

        # --- assemble the unit grid (upper triangle computed, mirrored) --
        m_units = len(units)
        cells = [[None] * m_units for _ in range(m_units)]
        for i, (kind_i, b_i, info_i) in enumerate(units):
            for j in range(i, m_units):
                kind_j, b_j, info_j = units[j]
                if i == j:
                    if kind_i == "dense":
                        cells[i][i] = dense_ops.sandwich(Xd, w)
                    elif kind_i == "sparse":
                        cells[i][i] = sparse_diag(b_i)
                    else:
                        cells[i][i] = cat_diag(info_i)
                elif (kind_i, kind_j) == ("dense", "cat"):
                    M = dense_cat_cell(info_j)  # (wc, kd)
                    cells[i][j], cells[j][i] = M.T, M
                elif (kind_i, kind_j) == ("cat", "dense"):
                    M = dense_cat_cell(info_i)
                    cells[i][j], cells[j][i] = M, M.T
                elif (kind_i, kind_j) == ("dense", "sparse"):
                    M = sparse_dense_cell(b_j)  # (ks, kd)
                    cells[i][j], cells[j][i] = M.T, M
                elif (kind_i, kind_j) == ("sparse", "dense"):
                    M = sparse_dense_cell(b_i)
                    cells[i][j], cells[j][i] = M, M.T
                elif (kind_i, kind_j) == ("sparse", "cat"):
                    M = sparse_cat_cell(b_i, info_j)  # (wc, ks)
                    cells[i][j], cells[j][i] = M.T, M
                elif (kind_i, kind_j) == ("cat", "sparse"):
                    M = sparse_cat_cell(b_j, info_i)
                    cells[i][j], cells[j][i] = M, M.T
                elif (kind_i, kind_j) == ("cat", "cat"):
                    M = cat_cat_cell(i, j, info_i, info_j)
                    cells[i][j], cells[j][i] = M, M.T
                else:
                    raise NotImplementedError(
                        f"sandwich cell {(kind_i, kind_j)}"
                    )

        if m_units == 1:
            H_concat = cells[0][0]
        else:
            H_concat = jnp.concatenate(
                [jnp.concatenate(r, axis=1) for r in cells], axis=0
            )
        if self._identity_order:
            return H_concat
        gidx = self._index_map
        return jnp.take(jnp.take(H_concat, gidx, axis=0), gidx, axis=1)


    # operator sugar so glm.irls_step works unchanged
    def __matmul__(self, v):
        return self.matvec(v)

    @property
    def T(self):
        return _TransposedDesign(self)


class _TransposedDesign:
    def __init__(self, design: DeviceDesign):
        self._design = design

    def __matmul__(self, r):
        return self._design.transpose_matvec(r)


def _design_flatten(d: DeviceDesign):
    children = []
    for b in d.blocks:
        children.extend(b.arrays.values())
    children.append(d.shift)
    children.append(d.mult)
    children.append(d._index_map)
    children.append(d._gather_v)
    aux = (
        tuple((b.kind, tuple(b.arrays.keys()), b.width, b.positions.tobytes(),
               b.positions.dtype.str, len(b.positions), b.meta) for b in d.blocks),
        d.shape,
        d._identity_order,
    )
    return children, aux


def _design_unflatten(aux, children):
    block_descs, shape, identity_order = aux
    d = object.__new__(DeviceDesign)
    blocks = []
    i = 0
    for kind, keys, width, pos_bytes, pos_dtype, pos_len, meta in block_descs:
        arrays = {}
        for k in keys:
            arrays[k] = children[i]
            i += 1
        positions = np.frombuffer(pos_bytes, dtype=np.dtype(pos_dtype), count=pos_len)
        blocks.append(_Block(kind, arrays, width, positions, meta=meta))
    d.blocks = blocks
    d.shape = shape
    d._identity_order = identity_order
    d.shift = children[i]
    d.mult = children[i + 1]
    d._index_map = children[i + 2]
    d._gather_v = children[i + 3]
    return d


jax.tree_util.register_pytree_node(DeviceDesign, _design_flatten, _design_unflatten)
