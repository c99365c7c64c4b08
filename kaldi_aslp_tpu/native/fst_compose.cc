// Native FST composition + connect for the graph builder.
//
// The reference builds decoding graphs with C++ OpenFst binaries
// (fsttablecompose / fstcomposecontext, src/fstext/table-matcher.h;
// driven by utils/mkgraph.sh and aslp_scripts/ctc/make_ctc_graph.sh).
// This is this framework's native equivalent of the hot op: the
// python Fst.compose dominates TLG construction (measured 35 s of a
// 47 s 175k-state build; ~7 min at 750k states).
//
// Semantics mirror kaldi_aslp_tpu/fst/fst.py Fst.compose EXACTLY —
// tropical weights, the standard 3-state epsilon-sequencing filter,
// followed by connect() with states renumbered by sorted original id —
// so the python and native paths are interchangeable and the tests
// assert identical output.
//
// Protocol (ctypes): the caller passes both machines as CSR arrays
// (machine 2's arcs must be STABLY sorted by ilabel within each state,
// which also matches the python's insertion-ordered grouping).  The
// result is held in an opaque handle: fst_compose() returns the handle
// and sizes, fst_compose_fetch() copies the arrays out,
// fst_compose_free() releases it.

#include <cstdint>
#include <cstring>
#include <deque>
#include <limits>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();

struct OutArc {
  int32_t src, il, ol, dst;
  float w;
};

struct Result {
  std::vector<OutArc> arcs;
  std::vector<float> finals;  // [num_states], inf = non-final
  int32_t start = -1;
  int64_t num_states = 0;
};

struct Csr {
  const int32_t* row;  // [S+1]
  const int32_t* il;
  const int32_t* ol;
  const float* w;
  const int32_t* dst;
  const float* fin;    // [S], inf = non-final
  int32_t S;
  int32_t start;
};

// product-state key: (s1, s2, filter) — filter in {0,1,2}
static inline uint64_t key_of(int64_t s1, int64_t s2, int64_t f,
                              int64_t S2) {
  return (uint64_t)((s1 * S2 + s2) * 3 + f);
}

Result* compose_impl(const Csr& A, const Csr& B) {
  auto* res = new Result();
  std::unordered_map<uint64_t, int32_t> ids;
  std::vector<int32_t> q1, q2, qf;  // product states by id
  std::vector<OutArc> arcs;

  auto get = [&](int32_t s1, int32_t s2, int32_t f) -> int32_t {
    uint64_t k = key_of(s1, s2, f, B.S);
    auto it = ids.find(k);
    if (it != ids.end()) return it->second;
    int32_t id = (int32_t)q1.size();
    ids.emplace(k, id);
    q1.push_back(s1);
    q2.push_back(s2);
    qf.push_back(f);
    return id;
  };

  std::deque<int32_t> queue;
  int32_t start = get(A.start, B.start, 0);
  queue.push_back(start);
  std::vector<float> finals;

  while (!queue.empty()) {
    int32_t cur = queue.front();
    queue.pop_front();
    int32_t s1 = q1[cur], s2 = q2[cur], f = qf[cur];
    if (finals.size() < q1.size()) finals.resize(q1.size(), kInf);
    if (A.fin[s1] != kInf && B.fin[s2] != kInf)
      finals[cur] = A.fin[s1] + B.fin[s2];

    const size_t before = ids.size();
    auto push = [&](int32_t n1, int32_t n2, int32_t nf, int32_t il,
                    int32_t ol, float w) {
      size_t prev = ids.size();
      int32_t nid = get(n1, n2, nf);
      if (ids.size() != prev) queue.push_back(nid);
      arcs.push_back({cur, il, ol, nid, w});
    };
    (void)before;

    // machine-2 arcs are ilabel-sorted per state: binary search the run
    auto b_lo = B.row[s2], b_hi = B.row[s2 + 1];
    auto run_of = [&](int32_t label, int32_t* lo, int32_t* hi) {
      int32_t l = b_lo, h = b_hi;
      while (l < h) {  // lower bound
        int32_t m = (l + h) / 2;
        if (B.il[m] < label) l = m + 1; else h = m;
      }
      *lo = l;
      h = b_hi;
      while (l < h) {  // upper bound
        int32_t m = (l + h) / 2;
        if (B.il[m] <= label) l = m + 1; else h = m;
      }
      *hi = l;
    };

    for (int32_t p = A.row[s1]; p < A.row[s1 + 1]; ++p) {
      if (A.ol[p] != 0) {
        int32_t lo, hi;
        run_of(A.ol[p], &lo, &hi);
        for (int32_t p2 = lo; p2 < hi; ++p2)
          push(A.dst[p], B.dst[p2], 0, A.il[p], B.ol[p2],
               A.w[p] + B.w[p2]);
      } else if (f != 2) {
        // eps-output move on the left machine
        push(A.dst[p], s2, 1, A.il[p], 0, A.w[p]);
      }
    }
    if (f != 1) {
      int32_t lo, hi;
      run_of(0, &lo, &hi);
      for (int32_t p2 = lo; p2 < hi; ++p2)
        push(s1, B.dst[p2], 2, 0, B.ol[p2], B.w[p2]);
    }
  }
  int64_t S = (int64_t)q1.size();
  if ((int64_t)finals.size() < S) finals.resize(S, kInf);

  // ---- connect(): accessible (all are, by construction) AND
  // coaccessible; renumber by sorted original id (fst.py connect) ----
  std::vector<std::vector<int32_t>> preds(S);
  for (const auto& a : arcs) preds[a.dst].push_back(a.src);
  std::vector<uint8_t> keep(S, 0);
  std::vector<int32_t> stack;
  for (int64_t s = 0; s < S; ++s)
    if (finals[s] != kInf) { keep[s] = 1; stack.push_back((int32_t)s); }
  while (!stack.empty()) {
    int32_t s = stack.back();
    stack.pop_back();
    for (int32_t p : preds[s])
      if (!keep[p]) { keep[p] = 1; stack.push_back(p); }
  }
  std::vector<int32_t> remap(S, -1);
  int32_t ns = 0;
  for (int64_t s = 0; s < S; ++s)
    if (keep[s]) remap[s] = ns++;
  res->num_states = ns;
  res->start = (start >= 0 && keep[start]) ? remap[start] : -1;
  res->finals.assign(ns, kInf);
  for (int64_t s = 0; s < S; ++s)
    if (keep[s] && finals[s] != kInf) res->finals[remap[s]] = finals[s];
  res->arcs.reserve(arcs.size());
  for (const auto& a : arcs)
    if (keep[a.src] && keep[a.dst])
      res->arcs.push_back({remap[a.src], a.il, a.ol, remap[a.dst], a.w});
  return res;
}

}  // namespace

extern "C" {

void* fst_compose(
    int32_t S1, const int32_t* row1, const int32_t* il1,
    const int32_t* ol1, const float* w1, const int32_t* dst1,
    const float* fin1, int32_t start1,
    int32_t S2, const int32_t* row2, const int32_t* il2,
    const int32_t* ol2, const float* w2, const int32_t* dst2,
    const float* fin2, int32_t start2,
    int64_t* out_nstates, int64_t* out_narcs, int32_t* out_start) {
  Csr A{row1, il1, ol1, w1, dst1, fin1, S1, start1};
  Csr B{row2, il2, ol2, w2, dst2, fin2, S2, start2};
  Result* r = compose_impl(A, B);
  *out_nstates = r->num_states;
  *out_narcs = (int64_t)r->arcs.size();
  *out_start = r->start;
  return r;
}

void fst_compose_fetch(void* handle, int32_t* src, int32_t* il,
                       int32_t* ol, float* w, int32_t* dst,
                       float* finals) {
  auto* r = (Result*)handle;
  for (size_t i = 0; i < r->arcs.size(); ++i) {
    src[i] = r->arcs[i].src;
    il[i] = r->arcs[i].il;
    ol[i] = r->arcs[i].ol;
    w[i] = r->arcs[i].w;
    dst[i] = r->arcs[i].dst;
  }
  std::memcpy(finals, r->finals.data(),
              r->finals.size() * sizeof(float));
}

void fst_compose_free(void* handle) { delete (Result*)handle; }

}  // extern "C"
