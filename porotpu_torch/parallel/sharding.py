"""Row sharding of the solver state over torch.distributed
(porotpu/parallel/sharding.py).

porotpu annotates its arrays with GSPMD shardings and lets XLA partition
the jitted solve.  PyTorch has no partitioner, so the port makes the same
1-D row partition explicit:

- each rank holds, for each field, its slab of ``padded_sizes[f] / W``
  rows (W the world size), and its vectors are ``[s_loc | f_loc | p_loc]``:
  the block preconditioner, the Schur fieldsplit and ``FieldMatrix``
  keep their slicing, on the local sizes;
- an operator keeps the slab of its rows and its global columns, and its
  ``dist`` tag (``ops/dia.py``) says how a product communicates: banded
  blocks exchange one left and one right halo per product and run K1 or
  K2 on the rank's slab, the others gather their input (a field at most);
- AMG levels >= 1, the dense coarse inverses and LU factors are
  replicated, porotpu's coarse-grid agglomeration (:209);
- dot products and norms are one all-reduce each (``solvers/``), and
  AAR's and Anderson's squared norm, Gram matrix and F f one all-reduce
  together; the host-side solves (Hessenberg, Gram) run on every rank
  alike.

Every solve path of the drivers runs on a mesh: FGMRES, cg and AAR as the
outer solve, Anderson acceleration of the PC output, every inner kind
and the quasi-exact ``fgmres+fs`` fp solve (its ``FieldMatrix`` and
Schur fieldsplit sharded over the fields (nf, npp), its FGMRES reducing
over the ranks).  The one layout ``shard_ell`` does not port, an
embedded ``Transposed`` into a replicated space, is in no solver tree
the drivers build (``tools/shard_walk.py``).

Communication lives only in the operators' products and in the solvers'
reductions.  Sharding slices the host-built modules before they move to
the device: a slab is a contiguous copy, and each rank keeps only its
own.  With no mesh nothing here runs.

``RowMesh`` runs NCCL on the card and gloo on the CPU; gloo on the card
(several ranks sharing one card) stages every message through the host.
A halo exchange can be started and waited on later
(``exchange_start``): under NCCL the halo matvec launches its interior
under it (``RowMesh.halo_split``).
``solver_mesh(n_hosts=H)`` checks that the ranks are host-major and
keeps the 1-D partition, so only neighbours at a host boundary
exchange across hosts.
``COLLECTIVES`` counts the collectives by (op, length), as
``dia_kernel.COUNTS`` counts launches: ``exchange`` one point-to-point
message a direction of a halo product, ``host_exchange`` those of them
sent to a rank on another host (a mesh over ``n_hosts``), ``allreduce``
and ``all_gather`` (its length that of the gathered vector); ``SENT``
counts the halo messages sent by the receiving rank.
"""

from __future__ import annotations

import collections
import datetime
import os
import socket

import torch
import torch.distributed as dist

COLLECTIVES = collections.Counter()
# halo messages this rank sent, by the receiving rank of the mesh
SENT = collections.Counter()
# seconds a collective may wait before the group fails, not hangs
TIMEOUT_S = 120.0


def reset_collectives():
    COLLECTIVES.clear()
    SENT.clear()


class PendingExchange:
    """A halo exchange in flight (``RowMesh.exchange_start``)."""

    def __init__(self, works, from_left, from_right, staged_left=None, staged_right=None):
        self.works = works
        self.from_left, self.from_right = from_left, from_right
        self.staged = (staged_left, staged_right)

    def wait(self):
        """(from_left, from_right), once the messages have arrived."""
        for work in self.works:
            work.wait()
        self.works = []
        if self.staged[0] is not None:
            self.from_left.copy_(self.staged[0])
            self.from_right.copy_(self.staged[1])
            self.staged = (None, None)
        return self.from_left, self.from_right


class RowMesh:
    """A 1-D row partition over the ranks of a process group.  With
    ``n_hosts`` H the ranks are H host-major blocks of W / H (``solver_mesh``
    checks the layout): the partition is the same, and the exchanges
    between two blocks are also counted as crossing a host."""

    def __init__(self, group, device: torch.device, owns_group: bool = False,
                 n_hosts: int = 1):
        self.group = group
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self.ranks = dist.get_process_group_ranks(group)
        self.device = torch.device(device)
        self.backend = dist.get_backend(group)
        # gloo takes host tensors point to point: stage a card's messages
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        # halo matvecs launch their interior under the exchange
        # (``ops/dia.py``) where the two can overlap: NCCL runs the messages
        # on its own stream, while gloo's wait, and on the card its staging
        # through the host, hold the host.  Else they wait, then launch once
        self.halo_split = self.backend == "nccl" and self.world > 1
        self.owns_group = owns_group
        self.n_hosts = int(n_hosts)
        self.per_host = self.world // self.n_hosts

    def __repr__(self):
        return (f"RowMesh(rank {self.rank} of {self.world}, {self.n_hosts} host(s), "
                f"{self.backend}, {self.device})")

    def _count_send(self, peer, n):
        COLLECTIVES["exchange", n] += 1
        if peer is not None:
            SENT[peer] += 1
            if peer // self.per_host != self.rank // self.per_host:
                COLLECTIVES["host_exchange", n] += 1

    def _host(self, t):
        return t.cpu() if self.staged else t

    def exchange(self, to_left: torch.Tensor, to_right: torch.Tensor):
        """One ``batch_isend_irecv`` with the two neighbours: ``to_left``
        goes to rank - 1 and ``to_right`` to rank + 1.  Returns (from_left,
        from_right): the left neighbour's ``to_right`` and the right
        neighbour's ``to_left``, zeros at the edges (the global zero
        padding).  Each rank passes the same lengths."""
        return self.exchange_start(to_left, to_right).wait()

    def exchange_start(self, to_left: torch.Tensor, to_right: torch.Tensor) -> "PendingExchange":
        """``exchange`` without waiting: posts the sends and receives and
        returns the pending exchange, whose ``wait()`` gives (from_left,
        from_right).  Under NCCL the messages run on NCCL's stream and
        ``wait`` makes the current stream wait for them, so work launched
        in between overlaps them on the card; gloo staged through the host
        has copied its sends to the host (a sync) before it returns."""
        from_left = to_right.new_zeros(to_right.shape)
        from_right = to_left.new_zeros(to_left.shape)
        if self.world == 1:
            return PendingExchange([], from_left, from_right)
        sl, sr = self._host(to_left).contiguous(), self._host(to_right).contiguous()
        rl, rr = self._host(from_left), self._host(from_right)
        left, right = self.rank - 1, self.rank + 1
        ops = []
        if to_left.numel():
            self._count_send(left if left >= 0 else None, to_left.numel())
            if left >= 0:
                ops.append(dist.P2POp(dist.isend, sl, self.ranks[left], self.group))
            if right < self.world:
                ops.append(dist.P2POp(dist.irecv, rr, self.ranks[right], self.group))
        if to_right.numel():
            self._count_send(right if right < self.world else None, to_right.numel())
            if right < self.world:
                ops.append(dist.P2POp(dist.isend, sr, self.ranks[right], self.group))
            if left >= 0:
                ops.append(dist.P2POp(dist.irecv, rl, self.ranks[left], self.group))
        works = dist.batch_isend_irecv(ops) if ops else []
        if self.staged:
            return PendingExchange(works, from_left, from_right, rl, rr)
        return PendingExchange(works, from_left, from_right)

    def _allreduce(self, t, op, name):
        COLLECTIVES[name, t.numel()] += 1
        buf = t.detach().to("cpu", copy=True) if self.staged else t.detach().clone()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device) if self.staged else buf

    def allreduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        return self._allreduce(t, dist.ReduceOp.SUM, "allreduce")

    def allreduce_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._allreduce(t, dist.ReduceOp.MAX, "allreduce")

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' 1-D tensors concatenated in rank order."""
        COLLECTIVES["all_gather", t.numel() * self.world] += 1
        src = self._host(t).contiguous()
        if self.backend == "nccl":
            out = src.new_empty(self.world * src.numel())
            dist.all_gather_into_tensor(out, src, group=self.group)
        else:
            parts = [torch.empty_like(src) for _ in range(self.world)]
            dist.all_gather(parts, src, group=self.group)
            out = torch.cat(parts)
        return out.to(t.device) if self.staged else out

    # -- the solvers' reductions ----------------------------------------

    def dot(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.allreduce_sum(torch.dot(a, b))

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.dot(x, x))

    # -- slabs -----------------------------------------------------------

    def slab_len(self, n: int, what: str = "length") -> int:
        if n % self.world:
            raise ValueError(
                f"{what} {n} does not divide into {self.world} ranks: set the "
                f"parameter 'pad multiple' to a multiple of the world size"
            )
        return n // self.world

    def slab(self, v: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a whole (replicated) vector or row block."""
        nloc = self.slab_len(v.shape[0])
        return v[self.rank * nloc : (self.rank + 1) * nloc].contiguous()

    def barrier(self):
        """One all-reduce: NCCL initialises lazily, so a group that cannot
        talk raises here and not in the first product."""
        self.allreduce_sum(torch.ones(1, device=self.device))

    def close(self):
        """Destroy the process group if ``solver_mesh`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self.owns_group = False


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def host_id(host=None) -> str:
    """This rank's host: ``host`` if given, else torchrun's GROUP_RANK (the
    node's rank), else the host name."""
    if host is not None:
        return str(host)
    if "GROUP_RANK" in os.environ:
        return "node " + os.environ["GROUP_RANK"]
    return socket.gethostname()


def check_host_major(hosts, n_hosts: int):
    """Raise ValueError unless the ranks' hosts (in rank order) allow
    ``n_hosts`` host-major blocks: W divisible by H and, when the ranks span
    more than one host, the ranks of block h, [h W/H, (h+1) W/H), all on one
    host (porotpu :72-90, its "not process-major" check).  Ranks all on one
    host are accepted, as porotpu accepts one process."""
    world = len(hosts)
    if world % n_hosts:
        raise ValueError(f"solver_mesh: {world} ranks do not divide into {n_hosts} hosts")
    if len(set(hosts)) == 1:
        return
    per = world // n_hosts
    blocks = [list(hosts[h * per : (h + 1) * per]) for h in range(n_hosts)]
    if not all(len(set(b)) == 1 for b in blocks):
        raise ValueError(
            "solver_mesh: the ranks are not host-major; each block of "
            f"{per} consecutive ranks must lie on one host (got hosts {blocks})"
        )


def solver_mesh(world: int | None = None, device="cuda", *, rank: int | None = None,
                init_method: str | None = None, backend: str | None = None,
                timeout: float = TIMEOUT_S, n_hosts: int | None = None,
                host=None) -> RowMesh:
    """The row mesh over the default process group (porotpu :52).

    Joins the default group if it exists, else makes it: ``rank`` and
    ``world`` from the arguments or torchrun's RANK / WORLD_SIZE,
    ``init_method`` from the argument, torchrun's MASTER_ADDR / PORT, or
    a free localhost port for a world of one.  The backend is NCCL on the
    card and gloo with ``device="cpu"``; ``backend="gloo"`` on the card
    lets ranks share one card (their messages pass through the host).
    NCCL that fails to initialise raises, and never gives way to gloo.
    ``device="cuda"`` picks ``cuda:<LOCAL_RANK>``.  Every collective
    fails after ``timeout`` seconds instead of hanging.

    ``n_hosts`` H: the ranks must be host-major (``check_host_major``),
    each rank's host from ``host`` (for tests), torchrun's GROUP_RANK or
    the host name, gathered from every rank.  The row partition stays
    1-D in rank order, so each host owns one contiguous slab of every
    field and only the exchanges between the last rank of a host and the
    first of the next cross hosts (``COLLECTIVES["host_exchange", n]``)."""
    n_hosts = 1 if n_hosts is None else int(n_hosts)
    if n_hosts < 1:
        raise ValueError(f"solver_mesh: n_hosts must be at least 1, got {n_hosts}")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "solver_mesh: torch sees no CUDA card; pass device='cpu' for gloo on the host"
            )
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("solver_mesh: NCCL needs a CUDA device")
    owns = False
    if not dist.is_initialized():
        rank = int(os.environ.get("RANK", 0)) if rank is None else int(rank)
        world = int(os.environ.get("WORLD_SIZE", 1)) if world is None else int(world)
        if init_method is None:
            if "MASTER_ADDR" in os.environ:
                init_method = "env://"
            elif world == 1:
                init_method = f"tcp://127.0.0.1:{_free_port()}"
            else:
                raise ValueError(
                    "solver_mesh: a world of several ranks needs init_method= or "
                    "torchrun's MASTER_ADDR / MASTER_PORT"
                )
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout),
        )
        owns = True
    elif world is not None and world != dist.get_world_size():
        raise ValueError(f"solver_mesh: asked for {world} ranks, the group has "
                         f"{dist.get_world_size()}")
    if n_hosts > 1:
        hosts = [None] * dist.get_world_size()
        dist.all_gather_object(hosts, host_id(host))
        try:
            check_host_major(hosts, n_hosts)
        except ValueError:
            if owns:
                dist.destroy_process_group()
            raise
    mesh = RowMesh(dist.group.WORLD, device, owns_group=owns, n_hosts=n_hosts)
    if mesh.backend != backend:
        raise ValueError(f"solver_mesh: the group runs {mesh.backend}, not {backend}")
    mesh.barrier()
    return mesh


# -- vectors -------------------------------------------------------------------


def shard_vector(x: torch.Tensor, mesh: RowMesh, sizes) -> torch.Tensor:
    """This rank's ``[s_loc | f_loc | p_loc]`` of a whole vector laid out in
    fields of ``sizes`` (porotpu :105).  A size the world does not divide
    raises."""
    parts, off = [], 0
    for n in sizes:
        nloc = mesh.slab_len(int(n), "field size")
        parts.append(x[off + mesh.rank * nloc : off + (mesh.rank + 1) * nloc])
        off += int(n)
    return torch.cat(parts).contiguous()


def gather_vector(x: torch.Tensor, mesh: RowMesh, local_sizes) -> torch.Tensor:
    """The whole vector from each rank's field slabs: one all-gather a
    field, none longer than a field."""
    parts, off = [], 0
    for n in local_sizes:
        parts.append(mesh.all_gather(x[off : off + int(n)]))
        off += int(n)
    return torch.cat(parts)


def local_index(mesh: RowMesh, sizes, idx):
    """(mask, local) for global indices into a vector laid out in fields
    of ``sizes``: which of them this rank holds, and where."""
    idx = torch.as_tensor(idx, dtype=torch.int64)
    mask = torch.zeros(idx.shape, dtype=torch.bool)
    local = torch.zeros(idx.shape, dtype=torch.int64)
    off = off_loc = 0
    for n in sizes:
        nloc = mesh.slab_len(int(n), "field size")
        lo = off + mesh.rank * nloc
        hit = (idx >= lo) & (idx < lo + nloc)
        mask |= hit
        local[hit] = idx[hit] - lo + off_loc
        off += int(n)
        off_loc += nloc
    return mask, local[mask]


# -- operators -----------------------------------------------------------------


def shard_ell(E, mesh: RowMesh, col_slab: bool = True, memo: dict | None = None):
    """Row-partition a host operator (porotpu :121): the slab of its rows,
    its columns global.  ``col_slab``: its column space (the input of the
    matvec, the output of the transpose) is a field in slabs; else it is
    replicated, as an AMG prolongator's coarse space.  Banded blocks take
    ``("halo", mesh)`` when the halo fits one slab and the embedded space
    is the row space, else ``("gather", mesh)``; ELL and Dense take
    ``("gather", mesh)``.  A sharded DIA drops ``dataT``, as porotpu's shard
    path does: its f32 transposes run K2.  A prolongator stored as
    ``Transposed`` becomes the DIA of its transposed layout (the
    prolongator banded over the fine rows), sharded as any other."""
    from ..ops.dia import DIA, Dense, Transposed, transpose_layout
    from ..ops.sparse import ELL, ell_transpose

    memo = {} if memo is None else memo
    key = (id(E), col_slab)
    if key in memo:
        return memo[key]
    if isinstance(E, Transposed) and not col_slab:
        # a prolongator stored as its banded transpose: its inner's rows are
        # the replicated coarse space.  Its transposed layout is the
        # prolongator itself, banded over the fine rows with negated offsets
        inner = E.inner
        if inner.col_emb is not None:
            # no solver tree of the drivers holds one (tools/shard_walk.py)
            raise NotImplementedError(
                "shard_ell: an embedded Transposed operator into a replicated space "
                "(ROADMAP M9.2)"
            )
        dataT = inner.dataT if inner.dataT is not None else transpose_layout(
            inner.data, inner.offsets, inner.ne)
        out = shard_ell(DIA(dataT, [-o for o in inner.offsets], inner.ne, inner.nrows,
                            ne=inner.nrows), mesh, False, memo)
    elif isinstance(E, Transposed):
        out = Transposed(shard_ell(E.inner, mesh, True, memo))
    else:
        nrows, ncols = E.shape
        nloc = mesh.slab_len(nrows, f"{type(E).__name__} rows")
        if col_slab:
            mesh.slab_len(ncols, f"{type(E).__name__} columns")
        r0, r1 = mesh.rank * nloc, (mesh.rank + 1) * nloc
        if isinstance(E, DIA):
            out = DIA(E.data[:, r0:r1].contiguous(), E.offsets, E.nrows, E.ncols, E.col_emb,
                      E.ne)
            hl, hr = max(0, -min(E.offsets)), max(0, max(E.offsets))
            halo = E.ne == E.nrows and hl <= nloc and hr <= nloc
            out.set_dist("halo" if halo else "gather", mesh, col_slab)
        elif isinstance(E, Dense):
            out = Dense(E.data[r0:r1].contiguous())
            out.set_dist(mesh, col_slab)
        elif isinstance(E, ELL):
            data, cols = E.data[r0:r1].contiguous(), E.cols[r0:r1].contiguous()
            dataT = colsT = None
            if E.dataT is not None:
                dT, colsT = ell_transpose(data.double().numpy(), cols.numpy(), E.ncols)
                dataT, colsT = torch.as_tensor(dT, dtype=data.dtype), torch.from_numpy(colsT)
            out = ELL(data, cols, E.ncols, dataT, colsT)
            out.set_dist(mesh, col_slab)
        else:
            raise TypeError(f"shard_ell: no row partition for {type(E).__name__}")
    memo[key] = out
    return out


def _shard_inner(solver, mesh: RowMesh, fields, memo: dict):
    """Shard an inner solver (porotpu :169): per-row data by rows, dense
    factors replicated.  ``fields``: the global field sizes of its block
    (two for the fluid-pressure block), which a replicated LU gathers and
    slabs by."""
    from ..precond.inner import InnerSolver

    if id(solver) in memo:
        return memo[id(solver)]
    k = solver.kind
    payload = {name: mod for name, mod in solver.mods.items()}
    for name, buf in solver.named_buffers(recurse=False):
        payload[name] = buf
    if k == "fgmres+fs":
        # the fp FieldMatrix and its Schur fieldsplit, each over the fields
        # (nf, npp); the inner FGMRES reduces over the ranks
        payload["A"] = shard_operator(payload["A"], mesh, memo)
        payload["fs"] = shard_operator(payload["fs"], mesh, memo)
    elif k in ("jacobi", "chebyshev", "cg"):
        if "A" in payload:
            payload["A"] = shard_ell(payload["A"], mesh, True, memo)
        if "dinv" in payload:
            payload["dinv"] = mesh.slab(payload["dinv"])
    elif k in ("amg", "cg+amg"):
        payload["A"] = shard_ell(payload["A"], mesh, True, memo)
        payload["amg"] = shard_amg(payload["amg"], mesh, memo)
    elif k == "plus-diag":
        payload["base"] = _shard_inner(payload["base"], mesh, fields, memo)
        payload["wdiag"] = mesh.slab(payload["wdiag"])
    # identity holds nothing; lu's inverse is replicated
    out = InnerSolver(k, payload, solver.iters, solver.lmax, solver.cheb_frac,
                      solver.monitor, solver.label)
    out.mesh = mesh
    out.fields = tuple(mesh.slab_len(int(n), "field size") for n in fields)
    memo[id(solver)] = out
    return out


def shard_amg(amg, mesh: RowMesh, memo: dict | None = None):
    """Level 0 row-sharded, levels >= 1 and the dense coarse inverse
    replicated (porotpu :209): level 0's A runs the halo products, its P
    maps the replicated coarse space into the slabs, and every rank runs
    the coarse levels whole and alike."""
    from ..precond.amg import AMG, AMGLevel

    memo = {} if memo is None else memo
    if id(amg) in memo:
        return memo[id(amg)]
    levels = []
    for li, lvl in enumerate(amg.levels):
        if li == 0:
            levels.append(AMGLevel(
                shard_ell(lvl.A, mesh, True, memo), shard_ell(lvl.P, mesh, False, memo),
                mesh.slab(lvl.dinv), lvl.lmax,
            ))
        else:
            levels.append(lvl)
    out = AMG(levels, amg.coarse_inv, amg.presmooth, amg.postsmooth, amg.cheb_lower)
    out.mesh = mesh
    memo[id(amg)] = out
    return out


def shard_operator(op, mesh: RowMesh, memo: dict | None = None, fields=None):
    """Shard any solver-side operator tree for the mesh (porotpu :250):
    operators, ``FieldMatrix``, inner solvers (``fields``: the global field
    sizes of their block), the Schur fieldsplit, ``CastPC``, the 2-way and
    3-way block preconditioners and a ``ModuleDict`` of operators."""
    from torch import nn

    from ..ops.dia import DIA, Dense, Transposed
    from ..ops.sparse import ELL, FieldMatrix
    from ..precond.block import BlockPreconditioner, CastPC
    from ..precond.inner import InnerSolver
    from ..precond.schur import SchurFieldsplit

    memo = {} if memo is None else memo
    if isinstance(op, (ELL, DIA, Dense, Transposed)):
        return shard_ell(op, mesh, True, memo)
    if isinstance(op, FieldMatrix):
        blocks = {(r, c): shard_ell(op.block(r, c), mesh, True, memo)
                  for r in op.sizes for c in op.sizes if op.block(r, c) is not None}
        return FieldMatrix(blocks, {k: mesh.slab_len(n, "field size")
                                    for k, n in op.sizes.items()})
    if isinstance(op, InnerSolver):
        if fields is None:
            raise ValueError("shard_operator: an inner solver needs the field sizes of its block")
        return _shard_inner(op, mesh, fields, memo)
    if isinstance(op, SchurFieldsplit):
        nf = op.nf
        npp = op.Apf.shape[0]
        return SchurFieldsplit(
            mesh.slab_len(nf, "field size"),
            _shard_inner(op.solve_f, mesh, (nf,), memo),
            _shard_inner(op.solve_S, mesh, (npp,), memo),
            shard_ell(op.Apf, mesh, True, memo),
        )
    if isinstance(op, CastPC):
        return CastPC(shard_operator(op.inner, mesh, memo), op.out_dtype, op.in_dtype)
    if isinstance(op, BlockPreconditioner):
        ns, nf, npp = op.ns, op.nf, op.np_

        def sh(x, flds):
            if x is None:
                return None
            if isinstance(x, (InnerSolver, SchurFieldsplit)):
                return shard_operator(x, mesh, memo, flds)
            return shard_ell(x, mesh, True, memo)

        mask = op.diff_rhs_mask
        return BlockPreconditioner(
            mesh.slab_len(ns, "field size"), mesh.slab_len(nf, "field size"),
            mesh.slab_len(npp, "field size"),
            sh(op.solve_s, (ns,)),
            solve_fp=sh(op.solve_fp, (nf, npp)),
            Pfs=sh(op.Pfs, None), Pps=sh(op.Pps, None),
            three_way=op.three_way,
            solve_f=sh(op.solve_f, (nf,)), solve_p=sh(op.solve_p, (npp,)),
            solve_diff=sh(op.solve_diff, (npp,)),
            Pfp=sh(op.Pfp, None), Psf=sh(op.Psf, None), Psp=sh(op.Psp, None),
            diff_rhs_mask=None if mask is None else mesh.slab(mask),
            w1=op.w1, w2=op.w2,
        )
    if isinstance(op, nn.ModuleDict):
        return nn.ModuleDict({k: shard_operator(v, mesh, memo) for k, v in op.items()})
    raise TypeError(f"shard_operator: no row partition for {type(op).__name__}")
