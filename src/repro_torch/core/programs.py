"""The paper's benchmark programs (§6 / Appendix B) in the loop DSL.

Same program set as Table 1 / Figure 3: Average, Count, Conditional Count/
Sum, Equal, String Match, Word Count, Histogram, Linear Regression,
Group-By, Matrix Addition/Multiplication, PageRank, KMeans, Matrix
Factorization.  Strings are dictionary-encoded to int codes (columnar
standard; DESIGN.md §2).
"""
from __future__ import annotations

from .frontend import bag, dim, loop_program, map_, matrix, scalar, vector


@loop_program
def average(V: bag[1], s: scalar, cnt: scalar, avg: scalar):
    for v in V:
        s += v
        cnt += 1.0
    avg = s / cnt


@loop_program
def count(V: bag[1], cnt: scalar):
    for v in V:
        cnt += 1.0


@loop_program
def conditional_count(V: bag[1], cnt: scalar, limit: scalar):
    for v in V:
        if v < limit:
            cnt += 1.0


@loop_program
def conditional_sum(V: bag[1], s: scalar, limit: scalar):
    for v in V:
        if v < limit:
            s += v


@loop_program
def equal(W: bag[1], first: scalar, diffs: scalar):
    # all strings equal <=> no element differs from the first (codes)
    for w in W:
        if w != first:
            diffs += 1.0


@loop_program
def string_match(W: bag[1], k1: scalar, k2: scalar, k3: scalar,
                 found: vector):
    for w in W:
        found[0] = max(found[0], float(w == k1))
        found[1] = max(found[1], float(w == k2))
        found[2] = max(found[2], float(w == k3))


@loop_program
def word_count(W: bag[1], C: map_):
    for i, w in items(W):
        C[w] += 1.0


@loop_program
def histogram(P: bag[3], R: map_, G: map_, B: map_):
    for r, g, b in P:
        R[r] += 1.0
        G[g] += 1.0
        B[b] += 1.0


@loop_program
def group_by(S: bag[2], C: map_):
    for k, v in S:
        C[k] += v


@loop_program
def linear_regression(P: bag[2], n: dim, sum_x: scalar, sum_y: scalar,
                      x_bar: scalar, y_bar: scalar, xx_bar: scalar,
                      xy_bar: scalar, slope: scalar, intercept: scalar):
    for x, y in P:
        sum_x += x
        sum_y += y
    x_bar = sum_x / n
    y_bar = sum_y / n
    for x, y in P:
        xx_bar += (x - x_bar) * (x - x_bar)
        xy_bar += (x - x_bar) * (y - y_bar)
    slope = xy_bar / xx_bar
    intercept = y_bar - slope * x_bar


@loop_program
def matrix_addition(M: matrix, N: matrix, R: matrix, n: dim, m: dim):
    for i in range(0, n):
        for j in range(0, m):
            R[i, j] = M[i, j] + N[i, j]


@loop_program
def matrix_multiplication(M: matrix, N: matrix, R: matrix,
                          n: dim, m: dim, l: dim):
    for i in range(0, n):
        for j in range(0, m):
            R[i, j] = 0.0
            for k in range(0, l):
                R[i, j] += M[i, k] * N[k, j]


@loop_program
def pagerank(E: bag[2], P: vector, NP: vector, C: vector, N: dim,
             num_steps: scalar, steps: scalar, b: scalar):
    for s, d in E:
        C[s] += 1.0
    while steps < num_steps:
        steps += 1.0
        for i in range(0, N):
            NP[i] = 0.0
        for s, d in E:
            NP[d] += P[s] / C[s]
        for i in range(0, N):
            P[i] = (1.0 - b) / N + b * NP[i]


@loop_program
def kmeans_step(P: bag[2], CX: vector, CY: vector, K: dim,
                D: matrix, MinD: vector, Cl: vector,
                SX: vector, SY: vector, CN: vector,
                NX: vector, NY: vector):
    for i, x, y in items(P):
        for j in range(0, K):
            D[i, j] = (x - CX[j]) * (x - CX[j]) + (y - CY[j]) * (y - CY[j])
    for i, x, y in items(P):
        for j in range(0, K):
            MinD[i] = min(MinD[i], D[i, j])
    for i, x, y in items(P):
        for j in range(0, K):
            Cl[i] = max(Cl[i], float(j) * float(D[i, j] == MinD[i])
                        - 1e9 * float(D[i, j] != MinD[i]))
    for i, x, y in items(P):
        SX[int(Cl[i])] += x
        SY[int(Cl[i])] += y
        CN[int(Cl[i])] += 1.0
    for j in range(0, K):
        NX[j] = SX[j] / max(CN[j], 1.0)
        NY[j] = SY[j] / max(CN[j], 1.0)


@loop_program
def matrix_factorization_step(R: matrix, P: matrix, Q: matrix,
                              Pp: matrix, Qp: matrix,
                              pq: matrix, err: matrix,
                              n: dim, m: dim, l: dim,
                              a: scalar, lam: scalar):
    # paper §3.2 (fixed version: pq / err are matrices, not scalars)
    for i in range(0, n):
        for j in range(0, m):
            pq[i, j] = 0.0
            for k in range(0, l):
                pq[i, j] += Pp[i, k] * Qp[k, j]
            err[i, j] = R[i, j] - pq[i, j]
            for k in range(0, l):
                P[i, k] += a * (2.0 * err[i, j] * Qp[k, j] - lam * Pp[i, k])
                Q[k, j] += a * (2.0 * err[i, j] * Pp[i, k] - lam * Qp[k, j])


# ---- rejected programs (paper §3.2 counterexamples) ----

def rejected_programs():
    """Programs the paper rejects; returned as (name, constructor) so tests can
    assert RejectionError at parse/check time."""
    from .frontend import parse_program

    def smoothing():
        def p(V: vector, n: dim):
            for i in range(1, n - 1):
                V[i] = (V[i - 1] + V[i + 1]) / 2.0
        return parse_program(p)

    def scalar_temp():
        def p(V: vector, W: vector, n: dim, t: scalar):
            for i in range(0, n):
                t = V[i]
                W[i] = t * 2.0
        return parse_program(p)

    def mf_scalar_pq():
        def p(R: matrix, P: matrix, Q: matrix, n: dim, m: dim, l: dim,
              pq: scalar, err: scalar):
            for i in range(0, n):
                for j in range(0, m):
                    pq = 0.0
                    for k in range(0, l):
                        pq += P[i, k] * Q[k, j]
                    err = R[i, j] - pq
        return parse_program(p)

    return [("smoothing", smoothing), ("scalar_temp", scalar_temp),
            ("mf_scalar_pq", mf_scalar_pq)]


ALL = {
    "average": average, "count": count,
    "conditional_count": conditional_count,
    "conditional_sum": conditional_sum, "equal": equal,
    "string_match": string_match, "word_count": word_count,
    "histogram": histogram, "group_by": group_by,
    "linear_regression": linear_regression,
    "matrix_addition": matrix_addition,
    "matrix_multiplication": matrix_multiplication,
    "pagerank": pagerank, "kmeans_step": kmeans_step,
    "matrix_factorization_step": matrix_factorization_step,
}
