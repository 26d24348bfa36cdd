"""The launch plan of kernels 9 and 11 (``ops/chebyshev._grid_plan``), on
the CPU: the row partition, the cooperative grid's size and threads, and
where the tables and kernel 11's on-chip state go, on an H100's 132 SMs and
232,448 bytes of opt-in shared memory a block (the sizes mirror
``csrc/cheb_grid.cuh``, ``cheb_filter.cu`` and ``cheb_moments.cu``)."""

import pytest

from pythtb_tpu_torch.ops import chebyshev

SMS, SMEM = 132, 232448


@pytest.mark.parametrize("norb", [1, 5, 37, 1798, 11164, 90000])
@pytest.mark.parametrize("nspin", [1, 2])
@pytest.mark.parametrize("B", [1, 12, 13, 64])
@pytest.mark.parametrize("kind", ["filter", "moments"])
def test_every_row_in_exactly_one_block(norb, nspin, B, kind):
    counts = chebyshev._GRID_THREADS[kind]
    G, T = chebyshev._grid_shape(norb, nspin, B, SMS, kind)
    assert 1 <= G <= min(SMS, norb) and T in counts
    rows = chebyshev._grid_rows(norb, nspin, G)
    assert len(rows) == G
    owner = [0] * (norb * nspin)
    for r0, r1 in rows:
        assert r0 % nspin == 0 and r1 % nspin == 0  # whole orbitals a block
        for r in range(r0, r1):
            owner[r] += 1
    assert owner == [1] * (norb * nspin)
    # blocks differ by at most one orbital, none is empty
    sizes = [(r1 - r0) // nspin for r0, r1 in rows]
    assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1
    # one pass of the row lanes holds a block's rows, with the fewest
    # threads that manage it, unless no thread count does: then 512
    lanes = T // min(B, T)
    if max(sizes) <= max(1, lanes // nspin):
        for fewer in counts[:counts.index(T)]:
            assert -(-norb // max(1, fewer // min(B, fewer) // nspin)) > SMS
    else:
        assert (G, T) == (SMS, 512)
        most = counts[-1]
        assert -(-norb // max(1, most // min(B, most) // nspin)) > SMS


@pytest.mark.parametrize("norb,nspin,B,kind,shape", [
    (11164, 1, 12, "filter", (132, 1024)),   # the TBG m=30 filter: 85 rows of 85 row lanes a block
    (800, 2, 12, "filter", (80, 256)),       # the Kane-Mele 20x20 spinful filter: 10 orbitals a block
    (90000, 1, 8, "moments", (132, 512)),    # kpm_dos 90k x 8: every SM, ~682 rows a block in 64 row lanes
    (5000, 1, 64, "moments", (132, 512)),    # kpm_ldos 5k x 64: 8 row lanes a block
    (1152, 1, 8, "recursion", (36, 256)),    # the Kubo torus, R 8: 32 row lanes a block
    (1798, 1, 12, "filter", (86, 256)),      # a ragged flake: 21 row lanes a block
    (37, 2, 3, "moments", (1, 256)),         # a small table: one block
    (11164, 1, 12, "moments", (132, 512)),   # kernel 9 takes no 1,024-thread block: many passes of 512
    (12000, 1, 8, "recursion", (132, 512)),  # 12,000 x 8 fits 1,024-thread blocks, kernel 9 takes 512
    (12000, 1, 8, "filter", (94, 1024)),
])
def test_grid_shape_at_the_main_path_shapes(norb, nspin, B, kind, shape):
    assert chebyshev._grid_shape(norb, nspin, B, SMS, kind) == shape


def test_tbg_filter_keeps_tables_and_state_in_shared_memory():
    plan = chebyshev._grid_plan(11164, 1, 12, 49, SMS, SMEM, "filter")
    # 85 orbitals a block: cols 16,660 -> 16,672 bytes, vals 66,640, acc and T_{m-1} 32,640
    assert plan == chebyshev.GridPlan(132, 1024, "shared", "shared", 16672 + 66640 + 32640)


@pytest.mark.parametrize("nspin,B", [(1, 1), (1, 12), (2, 12), (1, 64), (2, 64)])
def test_tables_leave_shared_memory_where_they_stop_fitting(nspin, B):
    """As the row degree D grows the filter's plan moves the tables to
    device memory at the first D whose tables and state overflow the
    block's shared memory, and keeps the state on chip; the moments plan
    moves them where the tables and its block sums (16 bytes a thread)
    overflow, the recursion's where the tables alone do."""
    norb = 11164
    G, T = chebyshev._grid_shape(norb, nspin, B, SMS, "filter")
    orbs = -(-norb // G)
    state = 2 * orbs * nspin * B * 16
    G9, T9 = chebyshev._grid_shape(norb, nspin, B, SMS, "moments")
    orbs9 = -(-norb // G9)
    places = []
    for D in range(1, 400):
        tables = chebyshev._grid_tables_bytes(orbs, D, nspin)
        tables9 = chebyshev._grid_tables_bytes(orbs9, D, nspin)
        plan = chebyshev._grid_plan(norb, nspin, B, D, SMS, SMEM, "filter")
        assert plan.blocks == G and plan.threads == T
        fits = tables + state <= SMEM
        assert plan.tables == ("shared" if fits else "device"), D
        assert plan.smem == (tables + state if fits else state if state <= SMEM else 0), D
        places.append(plan.tables)
        moments = chebyshev._grid_plan(norb, nspin, B, D, SMS, SMEM, "moments")
        assert (moments.blocks, moments.threads, moments.state) == (G9, T9, "none")
        assert moments.tables == ("shared" if tables9 + 16 * T9 <= SMEM else "device"), D
        recursion = chebyshev._grid_plan(norb, nspin, B, D, SMS, SMEM, "recursion")
        assert recursion.tables == ("shared" if tables9 <= SMEM else "device"), D
    if state <= SMEM:
        # shared up to one D, device from the next on
        first = places.index("device")
        assert set(places[:first]) == {"shared"} and set(places[first:]) == {"device"}


def test_state_leaves_shared_memory_where_it_stops_fitting():
    """90k rows at B 64: the block's acc and T_{m-1} (2 x 682 x 64
    complex, 1.4 MB) go to device memory with the tables."""
    plan = chebyshev._grid_plan(90000, 1, 64, 5, SMS, SMEM, "filter")
    assert plan == chebyshev.GridPlan(132, 512, "device", "device", 0)
    # the plan's shared-memory argument forces each placement
    G, _ = chebyshev._grid_shape(1798, 1, 12, SMS, "filter")
    st = 2 * -(-1798 // G) * 12 * 16
    assert chebyshev._grid_plan(1798, 1, 12, 4, SMS, st, "filter")[2:4] == ("device", "shared")
    assert chebyshev._grid_plan(1798, 1, 12, 4, SMS, st - 1, "filter")[2:4] == ("device", "device")
