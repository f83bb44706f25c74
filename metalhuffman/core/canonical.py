"""Canonical Huffman code construction (NumPy reference implementation).

Behavioral parity with the reference codec's canonical machinery:

- Bit-width table format: 256 bytes, one bit width per byte symbol, width 0 for
  unused symbols (reference: ``huff_util.hpp:45-68`` — the table IS the wire header).
- Canonical code assignment: symbols sorted by ``(bitWidth, symbol)``, codes assigned
  sequentially, code left-shifted when the width increases, stored *left-justified*
  in 16 bits (reference: ``huff_util.hpp:94-193``).
- Max code length 16 bits (reference: ``HuffmanEncoder.hpp:7-9``, asserts at
  ``HuffmanEncoder.cpp:168-170``). Unlike the reference — which simply asserts — we
  apply package-merge length limiting when the optimal tree would exceed the cap, so
  adversarial inputs still encode (at a documented, tiny size cost).
- Degenerate single-symbol alphabet: encoded as a single 1-bit code ``0`` (reference:
  ``HuffmanEncoder.cpp:118-121``).

This module is pure NumPy so it runs anywhere; the C++ library in
``metalhuffman/native`` mirrors it bit-for-bit and is the fast path.
"""

from __future__ import annotations

import heapq

import numpy as np

NUM_SYMBOLS = 256
MAX_CODE_LENGTH = 16


def symbol_frequencies(data: np.ndarray) -> np.ndarray:
    """Count byte frequencies (reference: ``HuffmanEncoder.cpp:28-51``)."""
    data = np.asarray(data, dtype=np.uint8).ravel()
    return np.bincount(data, minlength=NUM_SYMBOLS).astype(np.int64)


def _huffman_lengths_unlimited(freqs: np.ndarray) -> np.ndarray:
    """Optimal Huffman code lengths via a heap (O(n log n)).

    Any optimal prefix code has the same total encoded size, so this matches the
    reference encoder's compressed size exactly even though the reference builds
    its tree with an insertion-sorted array (``HuffmanEncoder.cpp:69-102``).
    Tie-breaking: (weight, smallest symbol in subtree) so results are deterministic.
    """
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.uint8)
    active = [int(s) for s in np.nonzero(freqs)[0]]
    if not active:
        return lengths
    if len(active) == 1:
        # Single symbol: 1-bit code (reference: HuffmanEncoder.cpp:118-121).
        lengths[active[0]] = 1
        return lengths

    # Heap of (weight, tiebreak, node_id); leaves are node ids 0..255,
    # internal nodes get ids >= 256. depth computed by propagating at the end.
    heap = [(int(freqs[s]), s, s) for s in active]
    heapq.heapify(heap)
    parent: dict[int, int] = {}
    next_id = NUM_SYMBOLS
    while len(heap) > 1:
        w1, t1, n1 = heapq.heappop(heap)
        w2, t2, n2 = heapq.heappop(heap)
        parent[n1] = next_id
        parent[n2] = next_id
        heapq.heappush(heap, (w1 + w2, min(t1, t2), next_id))
        next_id += 1

    depth: dict[int, int] = {heap[0][2]: 0}
    # Node ids are created in increasing order and parents always have larger
    # ids than children, so iterate ids downward.
    for nid in range(next_id - 1, -1, -1):
        if nid in parent:
            depth[nid] = depth[parent[nid]] + 1
    for s in active:
        lengths[s] = depth[s]
    return lengths


def _package_merge_lengths(freqs: np.ndarray, max_len: int) -> np.ndarray:
    """Length-limited Huffman lengths via the package-merge algorithm."""
    active = np.nonzero(freqs)[0]
    n = len(active)
    lengths = np.zeros(NUM_SYMBOLS, dtype=np.uint8)
    if n == 0:
        return lengths
    if n == 1:
        lengths[active[0]] = 1
        return lengths
    if n > (1 << max_len):
        raise ValueError(f"cannot code {n} symbols in <= {max_len} bits")

    # Each item is (weight, frozenset-of-leaf-indices) — but sets are slow; we
    # count leaf usage instead: item = (weight, leaf_count_array). For 256
    # symbols and 16 levels this is tiny.
    leaves = sorted((int(freqs[s]), int(s)) for s in active)
    counts = np.zeros(NUM_SYMBOLS, dtype=np.int32)

    # Standard package-merge: (max_len - 1) package+merge rounds, then take the
    # 2(n-1) cheapest items of the final merged list and count leaf occurrences.
    prev_packages: list[tuple[int, np.ndarray]] = []
    for _level in range(max_len - 1):
        items: list[tuple[int, int, np.ndarray]] = []
        for w, s in leaves:
            vec = np.zeros(NUM_SYMBOLS, dtype=np.int32)
            vec[s] = 1
            items.append((w, s, vec))
        for w, vec in prev_packages:
            items.append((w, NUM_SYMBOLS, vec))
        items.sort(key=lambda t: (t[0], t[1]))
        # Pair up adjacent items into packages for the next level.
        prev_packages = []
        for i in range(0, len(items) - 1, 2):
            w = items[i][0] + items[i + 1][0]
            vec = items[i][2] + items[i + 1][2]
            prev_packages.append((w, vec))

    # Take the 2(n-1) cheapest items from the final merge level.
    items = []
    for w, s in leaves:
        vec = np.zeros(NUM_SYMBOLS, dtype=np.int32)
        vec[s] = 1
        items.append((w, s, vec))
    for w, vec in prev_packages:
        items.append((w, NUM_SYMBOLS, vec))
    items.sort(key=lambda t: (t[0], t[1]))
    for w, _s, vec in items[: 2 * (n - 1)]:
        counts += vec
    lengths[active] = counts[active]
    return lengths


def huffman_code_lengths(
    freqs: np.ndarray, max_len: int = MAX_CODE_LENGTH
) -> np.ndarray:
    """Optimal (length-capped) Huffman bit widths for a 256-symbol alphabet.

    Returns the 256-entry uint8 bit-width table — exactly the wire-format
    canonical header of the reference (``huff_util.hpp:45-68``).
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    if freqs.shape != (NUM_SYMBOLS,):
        raise ValueError("freqs must have shape (256,)")
    lengths = _huffman_lengths_unlimited(freqs)
    if lengths.max(initial=0) > max_len:
        lengths = _package_merge_lengths(freqs, max_len)
    return lengths


def cluster_widths(freqs: np.ndarray, k: int = 6,
                   max_len: int = MAX_CODE_LENGTH) -> np.ndarray:
    """Best complete canonical width table using <= k DISTINCT code lengths.

    Re-quantizing the table to fewer lengths costs a little size for a
    simpler table — the moral twin of the reference's own empirical
    table-split tuning (``AAPLShaderTypes.h:114-118``). The decode kernel's
    per-symbol work does not depend on the number of lengths (it is a
    table lookup). Returns the optimal table unchanged when it already uses
    <= k lengths.

    Method: candidate allowed-length sets come from a contiguous-partition
    DP over the optimal table's distinct widths (each group rounds up to
    its deepest member — minimal mass-weighted round-up cost); the best
    few candidates are then tightened to the Kraft EQUALITY the decoders
    assume, via an exact branch-and-bound over per-length code counts
    (shorter lengths go to more frequent symbols). Cost is exact, so
    callers can compare total bits against the optimum and decide.
    """
    freqs = np.asarray(freqs, dtype=np.int64)
    opt = huffman_code_lengths(freqs, max_len)
    active = np.nonzero(freqs)[0]
    n = int(active.size)
    ds = np.unique(opt[active]).astype(np.int64)
    if n <= 2 or ds.size <= k:
        return opt
    order = active[np.lexsort((active, -freqs[active]))]  # freq desc, sym asc
    f_sorted = freqs[order]
    f_suffix = np.concatenate([np.cumsum(f_sorted[::-1])[::-1], [0]])
    smax_min = int(np.ceil(np.log2(n)))  # n codes must fit the deepest level

    # -- candidate sets: contiguous partitions of the distinct widths -------
    mass = np.array([int(freqs[active[opt[active] == w]].sum()) for w in ds],
                    dtype=np.int64)

    def roundup_cost(i, j):  # widths ds[i..j] -> ds[j]
        return int((mass[i : j + 1] * (ds[j] - ds[i : j + 1])).sum())

    d = ds.size
    INF = float("inf")
    dp = [[INF] * (d + 1) for _ in range(k + 1)]
    cut = [[0] * (d + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for g in range(1, k + 1):
        for j in range(1, d + 1):
            for i in range(g - 1, j):
                c = dp[g - 1][i] + roundup_cost(i, j - 1)
                if c < dp[g][j]:
                    dp[g][j] = c
                    cut[g][j] = i
    cands = []
    for g in range(2, k + 1):
        if dp[g][d] == INF:
            continue
        S, j = [], d
        for gg in range(g, 0, -1):
            S.append(int(ds[j - 1]))
            j = cut[gg][j]
        S = sorted(set(S))
        S[-1] = min(max_len, max(S[-1], smax_min))
        cands.append(tuple(sorted(set(S))))

    # -- exact tightening: optimal complete counts for an allowed set -------
    def counts_cost(lengths):
        units = [1 << (max_len - s) for s in lengths]
        target = 1 << max_len
        best = [None, float("inf")]
        stack = []

        def dfs(i, used, left_units, cost):
            # admissible bound: every remaining symbol at the current
            # (shortest remaining) length
            if cost + int(f_suffix[used]) * lengths[i] >= best[1]:
                return
            rem = n - used
            if i == len(lengths) - 1:
                if rem * units[i] == left_units:
                    best[0] = tuple(stack) + (rem,)
                    best[1] = cost + int(f_suffix[used]) * lengths[i]
                return
            u = units[i]
            for c in range(min(rem, left_units // u), -1, -1):
                if left_units - c * u > (rem - c) * units[i + 1]:
                    break  # tail cannot absorb the rest; fewer c is worse
                stack.append(c)
                dfs(i + 1, used + c, left_units - c * u,
                    cost + int(f_sorted[used : used + c].sum()) * lengths[i])
                stack.pop()

        dfs(0, 0, target, 0)
        return (best[0], best[1]) if best[0] is not None else None

    best_widths, best_cost = None, float("inf")
    for S in dict.fromkeys(cands):
        r = counts_cost(list(S))
        if r is None:
            continue
        counts, cost = r
        if cost < best_cost:
            best_cost = cost
            widths = np.zeros(NUM_SYMBOLS, np.uint8)
            pos = 0
            for s_len, c in zip(S, counts):
                widths[order[pos : pos + c]] = s_len
                pos += c
            best_widths = widths
    if best_widths is None:
        return opt  # no feasible clustered table: keep the optimum
    validate_widths(best_widths)
    return best_widths


def validate_widths(widths: np.ndarray) -> None:
    """Check the width table satisfies the Kraft equality (complete code)."""
    widths = np.asarray(widths, dtype=np.int64)
    nz = widths[widths > 0]
    if nz.size == 0:
        raise ValueError("width table has no active symbols")
    if nz.max() > MAX_CODE_LENGTH:
        raise ValueError("code length exceeds 16 bits")
    kraft = np.sum(2.0 ** (MAX_CODE_LENGTH - nz))
    full = float(1 << MAX_CODE_LENGTH)
    if nz.size == 1:
        # Single active symbol: the canonical assignment always gives it a
        # 1-bit code (Kraft sum 1/2; the decoder only ever reads '0' bits).
        # Any other width here is a corrupt or hand-mangled table.
        if nz[0] != 1:
            raise ValueError(
                f"single-symbol table must use width 1, got {int(nz[0])}")
        return
    if kraft != full:
        raise ValueError(
            f"width table is not a complete prefix code (kraft={kraft}/{full})"
        )


def canonical_codes(widths: np.ndarray) -> np.ndarray:
    """Left-justified 16-bit canonical codes from a width table.

    Matches the reference's assignment exactly (``huff_util.hpp:94-193``):
    sort active symbols by ``(width, symbol)``, assign sequential codes,
    left-shift the running code when width increases, left-justify into 16 bits.
    Unused symbols get code 0.
    """
    widths = np.asarray(widths, dtype=np.uint8)
    if widths.shape != (NUM_SYMBOLS,):
        raise ValueError("widths must have shape (256,)")
    codes = np.zeros(NUM_SYMBOLS, dtype=np.uint16)
    active = np.nonzero(widths)[0]
    if active.size == 0:
        return codes
    order = np.lexsort((active, widths[active]))
    syms = active[order]
    ws = widths[active][order].astype(np.int64)

    current = 0
    for i, (s, w) in enumerate(zip(syms, ws)):
        codes[s] = np.uint16((current << (16 - w)) & 0xFFFF)
        current += 1
        if i + 1 < len(syms) and ws[i + 1] > w:
            current <<= int(ws[i + 1] - w)
    return codes
