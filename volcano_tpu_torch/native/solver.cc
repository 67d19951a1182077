// Native CPU gang-allocate solver (counterpart of
// volcano_tpu/native/solver.cc), behind the solver conf's `kernel: native`.
//
// Semantics: those of the plain PyTorch loop, ops/allocate.py:
// gang_allocate. Each step of the current job fits (idle and future
// capacity, pod cap, the group's static mask and the task's domain slot)
// and scores (binpack + least + most + balanced + static + topology pack
// bonus) every node, takes the argmax with the lowest node index on ties,
// pipelines onto future capacity when nothing fits idle and updates the
// node's state; at the job's end the gang ready/kept decision, the
// rollback of a failed gang, the queue and namespace charge, and the next
// (namespace, queue) pool's job.
//
// Decision procedure (the reference's native solver):
//
//   * a top-C2 candidate table per fit class (idle, future), by score
//     descending and node index ascending, refreshed by one sweep of every
//     node when the touch budget is spent (C2 placements), when the
//     topology bucket changes, and when the group's CONTENT changes: the
//     request row, mask row, static-score row and pack bonus are compared
//     with memcmp, so the shape-identical gangs of a production batch
//     share one table;
//   * with domain slots (the constraint compiler's task_slot [T] and
//     slot_ok [S+1, N], ops/constraints.py) one sub-table per slot row,
//     all built by the one sweep of a refresh; a task serves from its
//     slot's table. A placement lands its node in every table whose
//     domain holds it: updated in place when present, inserted into the
//     table's overflow rows when not, so every node whose state changed
//     since the refresh is in every table it belongs to;
//   * an undo log of each placement's previous node state for the gang
//     rollback;
//   * the namespace-primary pool selection of ops/allocate.py:
//     make_pool_select.
//
// The table is exact, ties included: within a table's life at most C2 - 1
// nodes are placed on before a serve, only placed-on nodes change state,
// and they are in the table, so an untouched node outside a table is
// dominated by an untouched row of its class. The pack term keeps the
// argument: the pack row is reset (a new epoch) at every step whose task
// is not in the previous task's bucket, valid or not, exactly as the plain
// loop zeroes it; a table built while every node's pack was zero survives
// a reset (the placed-on rows are rescored), and any other table is
// dropped by one.
//
// Where this differs from the reference's solver.cc:
//
//   * Floating point: exact against the port's plain loop, not against
//     XLA. Every score is computed in ops/score.py's operation order, one
//     rounding per operation: no std::fmaf, built with -ffp-contract=off
//     given explicitly (GCC's GNU-mode default is fast) and without
//     -ffast-math (native/build.py). The CUDA kernel rounds the same way
//     under -fmad=false (csrc/gang_allocate.cu). A table is ranked by the
//     score a step serves, s + (static + pack * bonus).
//   * Rollback restores the node state from the undo log and then drops
//     the tables, so the next step refreshes, as the CUDA kernel does; no
//     table row is restored.
//   * Every R >= 2: the undo entry is 2 + 2R floats in an arena (the node,
//     its pod count, its idle and future rows), as the CUDA kernel's
//     [T, 2 + 2R] undo log is, and table rows keep their R-wide state in
//     arenas of their own.
//   * The pack row's reset at padding steps and slots outside 0..S (which
//     admit no node) follow the plain loop.
//
// Reference semantics: pkg/scheduler/actions/allocate/allocate.go:120-270
// (see ops/allocate.py's docstring for the mapping).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr float BIG = 1e30f;

struct Args {
  int32_t T, G, J, Q, P, NS, N, R;
  int32_t C2;                 // candidate-table rows per fit class
  int32_t S;                  // slot rows - 1; -1 = no slots
  const int32_t* task_group;  // [T]
  const int32_t* task_job;
  const uint8_t* task_valid;
  const int32_t* task_slot;   // [T] or null
  const int32_t* task_bucket;
  const float* group_req;     // [G,R]
  const uint8_t* group_mask;  // [G,N]
  const float* group_static;  // [G,N]
  const uint8_t* slot_ok;     // [S+1,N] or null
  const float* pack_bonus;    // [G]
  const int32_t* job_min;     // [J]
  const int32_t* job_base;
  const int32_t* job_start;
  const int32_t* job_ntasks;
  const int32_t* pool_queue;  // [P]
  const int32_t* pool_ns;
  const int32_t* pool_job_start;
  const int32_t* pool_njobs;
  const float* ns_weight;     // [NS]
  const float* ns_alloc0;     // [NS,R]
  const float* ns_total;      // [R]
  const float* q_deserved;    // [Q,R]
  const float* q_alloc0;      // [Q,R]
  const float* node_idle;     // [N,R]
  const float* node_future;
  const float* node_alloc;
  const int32_t* node_ntasks; // [N]
  const int32_t* node_max;    // [N]
  const float* eps;           // [R]
  const float* binpack_res;   // [R]
  float w_binpack, w_least, w_most, w_balanced;
  int32_t allow_pipeline, ns_live;
  // outputs
  int32_t* assign;            // [T]
  uint8_t* out_pipelined;     // [T]
  uint8_t* out_ready;         // [J]
  uint8_t* out_kept;          // [J]
  float* out_idle;            // [N,R]
  float* out_future;          // [N,R]
  int32_t* out_ntasks;        // [N]
  float* out_q_alloc;         // [Q,R]
  float* out_ns_alloc;        // [NS,R]
  int32_t* out_p_cursor;      // [P]
  int32_t* out_stats;         // [2]: table refreshes, gang rollbacks
};

// torch's max over a row: NaN wins
static inline float nan_max(float m, float x) {
  return (std::isnan(x) || x > m) ? x : m;
}

// torch.argmin over v[0..n): the first NaN, else the first minimum
struct ArgMin {
  int idx = 0;
  float best = 0.0f;
  bool any = false;
  inline void offer(int i, float v) {
    if (!any) { idx = i; best = v; any = true; return; }
    if (std::isnan(best)) return;
    if (std::isnan(v) || v < best) { idx = i; best = v; }
  }
};

struct Solver {
  const Args& a;
  const int N, R, C2;

  // node state in plane layout [r][n] (the sweep reads one plane at a time)
  std::vector<float> idleT, futT, allocT;
  std::vector<int32_t> ntasks;
  // the pack row: pack_of(n) = pack_val[n] when pack_epoch[n] == epoch,
  // else 0; a reset is a new epoch
  std::vector<float> pack_val;
  std::vector<int32_t> pack_epoch;
  int32_t epoch = 1;
  int placed_since_reset = 0;
  int32_t cur_bucket = -1;
  // fair-share state
  std::vector<float> q_alloc, ns_alloc;
  std::vector<int32_t> p_cursor;
  std::vector<uint8_t> ready, kept;

  // sweep buffers
  std::vector<float> sw_score, sw_acc, sw_f;
  std::vector<uint8_t> sw_fi, sw_ff;

  // Tables: TT = 1 without slots (every node), S+1 with them (table t =
  // the nodes of slot row t). Per table: [C2 idle-class rows][OV overflow
  // rows][C2 future-class rows]; OV = C2 with slots, else 0 (with one
  // table a placed-on node is always in it).
  bool slots = false;
  int TT = 1, OV = 0, STRIDE = 0;
  struct Row {
    int32_t gidx;       // -1 = dead
    int32_t ntasks, maxt;
    int32_t pepoch;     // the epoch of `pack`
    float stat, pack;
    float score;        // cached serve score
    uint8_t fi, ff;     // cached fits per class
  };
  std::vector<Row> rows;                   // [TT*STRIDE]
  std::vector<float> r_idle, r_fut, r_alloc;   // [TT*STRIDE*R]
  // (table, node) -> its idle-class / future-class row, valid for the
  // generation it was written in
  std::vector<int32_t> rowmap_i, rowmap_f, rowmap_gen;   // [TT*N]
  std::vector<int32_t> ov_used;            // [TT]
  std::vector<int32_t> mem_off, mem_slot;  // node -> member tables (CSR)
  std::vector<int32_t> packed_rows;        // rows with pack at this epoch
  std::vector<int32_t> dirty_rows;         // rows to rescore before serving
  int32_t gen = 1;
  int table_group = -1, verified_group = -1;
  int32_t table_bucket = -2;
  int touched = 0;
  bool have_table = false;
  bool table_pack_clean = false;   // every pack was 0 at the refresh

  // the undo log of the current gang: 2 + 2R floats an entry
  std::vector<float> undo;
  int32_t refreshes = 0, rollbacks = 0;

  explicit Solver(const Args& args)
      : a(args), N(args.N), R(args.R), C2(args.C2) {
    idleT.resize((size_t)R * N);
    futT.resize((size_t)R * N);
    allocT.resize((size_t)R * N);
    for (int n = 0; n < N; ++n)
      for (int r = 0; r < R; ++r) {
        idleT[(size_t)r * N + n] = a.node_idle[(size_t)n * R + r];
        futT[(size_t)r * N + n] = a.node_future[(size_t)n * R + r];
        allocT[(size_t)r * N + n] = a.node_alloc[(size_t)n * R + r];
      }
    ntasks.assign(a.node_ntasks, a.node_ntasks + N);
    pack_val.assign(N, 0.0f);
    pack_epoch.assign(N, 0);
    q_alloc.assign(a.q_alloc0, a.q_alloc0 + (size_t)a.Q * R);
    ns_alloc.assign(a.ns_alloc0, a.ns_alloc0 + (size_t)a.NS * R);
    p_cursor.assign(a.P, 0);
    ready.assign(a.J, 0);
    kept.assign(a.J, 0);
    sw_score.assign(N, 0.0f);
    sw_acc.assign(N, 0.0f);
    sw_f.assign(6 * (size_t)N, 0.0f);
    sw_fi.assign(N, 0);
    sw_ff.assign(N, 0);
    slots = a.S >= 0 && a.task_slot && a.slot_ok;
    TT = slots ? a.S + 1 : 1;
    OV = slots ? C2 : 0;
    STRIDE = 2 * C2 + OV;
    const size_t K = (size_t)TT * STRIDE;
    rows.assign(K, Row{});
    for (auto& r : rows) r.gidx = -1;
    r_idle.assign(K * R, 0.0f);
    r_fut.assign(K * R, 0.0f);
    r_alloc.assign(K * R, 0.0f);
    rowmap_i.assign((size_t)TT * N, -1);
    rowmap_f.assign((size_t)TT * N, -1);
    rowmap_gen.assign((size_t)TT * N, 0);
    ov_used.assign(TT, 0);
    mem_off.assign(N + 1, 0);
    if (slots) {
      for (int t = 0; t < TT; ++t) {
        const uint8_t* row = &a.slot_ok[(size_t)t * N];
        for (int n = 0; n < N; ++n) mem_off[n + 1] += row[n] ? 1 : 0;
      }
      for (int n = 0; n < N; ++n) mem_off[n + 1] += mem_off[n];
      mem_slot.assign(mem_off[N], 0);
      std::vector<int32_t> cur(mem_off.begin(), mem_off.end() - 1);
      for (int t = 0; t < TT; ++t) {
        const uint8_t* row = &a.slot_ok[(size_t)t * N];
        for (int n = 0; n < N; ++n)
          if (row[n]) mem_slot[cur[n]++] = t;
      }
    } else {
      for (int n = 0; n < N; ++n) mem_off[n + 1] = n + 1;
      mem_slot.assign(N, 0);
    }
  }

  // the task's table, or -1 when its slot admits no node
  inline int table_of(int32_t t_idx) const {
    if (!slots) return 0;
    int32_t s = a.task_slot[t_idx];
    return (s >= 0 && s < TT) ? s : -1;
  }

  inline float pack_of(int n) const {
    return pack_epoch[n] == epoch ? pack_val[n] : 0.0f;
  }

  // ---- the pool selection (ops/allocate.py:make_pool_select)
  void select(int32_t* out_pool, int32_t* out_job) {
    const int Q = a.Q, P = a.P, NS = a.NS;
    std::vector<float> share(Q);
    std::vector<uint8_t> over(Q);
    for (int q = 0; q < Q; ++q) {
      const float* al = &q_alloc[(size_t)q * R];
      const float* d = &a.q_deserved[(size_t)q * R];
      float m = 0.0f;
      bool ov = false;
      for (int r = 0; r < R; ++r) {
        float frac;
        if (std::isinf(d[r])) frac = 0.0f;
        else if (d[r] == 0.0f) frac = al[r] == 0.0f ? 0.0f : 1.0f;
        else frac = al[r] / d[r];
        m = r == 0 ? frac : nan_max(m, frac);
        if (!((al[r] <= d[r] + a.eps[r]) || std::isinf(d[r]))) ov = true;
      }
      share[q] = m;
      over[q] = ov;
    }
    std::vector<uint8_t> pool_ok(P), ns_has(NS, 0);
    for (int p = 0; p < P; ++p) {
      int q = a.pool_queue[p];
      pool_ok[p] = p_cursor[p] < a.pool_njobs[p] && q >= 0 && q < Q &&
                   !over[q];
      int ns = a.pool_ns[p];
      if (pool_ok[p] && ns >= 0 && ns < NS) ns_has[ns] = 1;
    }
    ArgMin ns_pick;
    for (int ns = 0; ns < NS; ++ns) {
      float key;
      if (a.ns_live) {
        const float* al = &ns_alloc[(size_t)ns * R];
        float m = 0.0f;
        for (int r = 0; r < R; ++r) {
          float t = a.ns_total[r];
          float frac = t > 0.0f ? al[r] / t : (al[r] == 0.0f ? 0.0f : 1.0f);
          m = r == 0 ? frac : nan_max(m, frac);
        }
        key = m / a.ns_weight[ns];
      } else {
        key = (float)ns;
      }
      ns_pick.offer(ns, ns_has[ns] ? key : BIG);
    }
    const int ns_sel = ns_pick.idx;
    ArgMin p_pick;
    for (int p = 0; p < P; ++p) {
      bool ok = pool_ok[p] && a.pool_ns[p] == ns_sel;
      p_pick.offer(p, ok ? share[a.pool_queue[p]] : BIG);
    }
    if (NS > 0 && P > 0 && ns_has[ns_sel]) {
      *out_pool = p_pick.idx;
      *out_job = a.pool_job_start[p_pick.idx] + p_cursor[p_pick.idx];
    } else {
      *out_pool = -1;
      *out_job = -1;
    }
  }

  // ---- the score of ops/score.py:node_score, one rounding an operation,
  // without the static term: binpack, then least, most, balanced
  inline float score_base(const float* req, const float* idle,
                          const float* alloc) const {
    float wsum = 0.0f, acc = 0.0f;
    for (int r = 0; r < R; ++r) {
      bool requested = req[r] > 0.0f && a.binpack_res[r] > 0.0f;
      float wr = requested ? a.binpack_res[r] : 0.0f;
      float used = alloc[r] - idle[r];
      float denom = std::max(alloc[r], 1e-9f);
      float frac = alloc[r] > 0.0f ? (used + req[r]) / denom : 2.0f;
      float per = frac <= 1.0f ? frac * 100.0f : 0.0f;
      float term = per * wr;
      acc = r == 0 ? term : acc + term;
      wsum = r == 0 ? wr : wsum + wr;
    }
    float bp = acc / std::max(wsum, 1e-9f);
    float fl[2], fm[2], fb[2];
    for (int r = 0; r < 2; ++r) {
      float al = alloc[r];
      float u = (al - idle[r]) + req[r];
      float denom = std::max(al, 1e-9f);
      bool pos = al > 0.0f;
      fl[r] = (pos ? std::max(al - u, 0.0f) / denom : 0.0f) * 100.0f;
      fm[r] = (pos ? std::min(std::max(u, 0.0f), al) / denom : 0.0f) * 100.0f;
      fb[r] = pos ? u / denom : 0.0f;
    }
    float least = (fl[0] + fl[1]) / 2.0f;
    float most = (fm[0] + fm[1]) / 2.0f;
    float balanced = 100.0f - std::fabs(fb[0] - fb[1]) * 100.0f;
    float s = a.w_binpack * bp;
    float t1 = a.w_least * least;
    s = s + t1;
    float t2 = a.w_most * most;
    s = s + t2;
    float t3 = a.w_balanced * balanced;
    s = s + t3;
    return s;
  }

  inline bool fits(const float* req, const float* cap) const {
    for (int r = 0; r < R; ++r)
      if (!(req[r] <= cap[r] + a.eps[r])) return false;
    return true;
  }

  inline float row_pack(const Row& r) const {
    return r.pepoch == epoch ? r.pack : 0.0f;
  }

  // the serve score and fits of row k under the group (req, bonus)
  void row_score(int k, const float* req, float bonus) {
    Row& r = rows[k];
    if (r.gidx < 0) return;
    const float* ri = &r_idle[(size_t)k * R];
    const float* rf = &r_fut[(size_t)k * R];
    const float* ra = &r_alloc[(size_t)k * R];
    float stat_eff = r.stat + row_pack(r) * bonus;
    r.score = score_base(req, ri, ra) + stat_eff;
    bool pods_ok = r.maxt == 0 || r.ntasks < r.maxt;
    r.fi = pods_ok && fits(req, ri);
    r.ff = a.allow_pipeline && pods_ok && fits(req, rf);
  }

  void load_row(int k, int n, const float* stat) {
    Row& r = rows[k];
    r.gidx = n;
    r.stat = stat[n];
    r.pack = pack_of(n);
    r.pepoch = epoch;
    r.ntasks = ntasks[n];
    r.maxt = a.node_max[n];
    for (int rr = 0; rr < R; ++rr) {
      r_idle[(size_t)k * R + rr] = idleT[(size_t)rr * N + n];
      r_fut[(size_t)k * R + rr] = futT[(size_t)rr * N + n];
      r_alloc[(size_t)k * R + rr] = allocT[(size_t)rr * N + n];
    }
    if (r.pack != 0.0f) packed_rows.push_back(k);
  }

  // ---- a refresh: fits and scores of every node (pass A, over the
  // planes), then the top-C2 per (table, class) (pass B), then the rows
  void refresh(int g, int32_t b, const float* req, float bonus) {
    refreshes++;
    const uint8_t* mask = &a.group_mask[(size_t)g * N];
    const float* stat = &a.group_static[(size_t)g * N];
    float* score = sw_score.data();
    float* acc = sw_acc.data();
    uint8_t* fi = sw_fi.data();
    uint8_t* ff = sw_ff.data();
    for (int n = 0; n < N; ++n) {
      uint8_t ok = mask[n] &&
          ((a.node_max[n] == 0) | (ntasks[n] < a.node_max[n]));
      fi[n] = ok;
      ff[n] = a.allow_pipeline ? ok : 0;
    }
    float wsum = 0.0f;
    for (int r = 0; r < R; ++r) {
      const float* ip = &idleT[(size_t)r * N];
      const float* fp = &futT[(size_t)r * N];
      const float* ap = &allocT[(size_t)r * N];
      const float rq = req[r], ep = a.eps[r];
      bool requested = rq > 0.0f && a.binpack_res[r] > 0.0f;
      const float wr = requested ? a.binpack_res[r] : 0.0f;
      wsum = r == 0 ? wr : wsum + wr;
      for (int n = 0; n < N; ++n) {
        fi[n] &= (uint8_t)(rq <= ip[n] + ep);
        ff[n] &= (uint8_t)(rq <= fp[n] + ep);
        float al = ap[n];
        float used = al - ip[n];
        float denom = std::max(al, 1e-9f);
        float frac = al > 0.0f ? (used + rq) / denom : 2.0f;
        float per = frac <= 1.0f ? frac * 100.0f : 0.0f;
        float term = per * wr;
        acc[n] = r == 0 ? term : acc[n] + term;
      }
    }
    wsum = std::max(wsum, 1e-9f);
    float* fl0 = sw_f.data();
    float* fm0 = fl0 + N;
    float* fb0 = fm0 + N;
    float* fl1 = fb0 + N;
    float* fm1 = fl1 + N;
    float* fb1 = fm1 + N;
    for (int r = 0; r < 2; ++r) {
      const float* ip = &idleT[(size_t)r * N];
      const float* ap = &allocT[(size_t)r * N];
      const float rq = req[r];
      float* fl = r == 0 ? fl0 : fl1;
      float* fm = r == 0 ? fm0 : fm1;
      float* fb = r == 0 ? fb0 : fb1;
      for (int n = 0; n < N; ++n) {
        float al = ap[n];
        float u = (al - ip[n]) + rq;
        float denom = std::max(al, 1e-9f);
        bool pos = al > 0.0f;
        fl[n] = (pos ? std::max(al - u, 0.0f) / denom : 0.0f) * 100.0f;
        fm[n] = (pos ? std::min(std::max(u, 0.0f), al) / denom : 0.0f) *
                100.0f;
        fb[n] = pos ? u / denom : 0.0f;
      }
    }
    const float wb = a.w_binpack, wl = a.w_least, wm = a.w_most,
                wba = a.w_balanced;
    for (int n = 0; n < N; ++n) {
      float bp = acc[n] / wsum;
      float least = (fl0[n] + fl1[n]) / 2.0f;
      float most = (fm0[n] + fm1[n]) / 2.0f;
      float balanced = 100.0f - std::fabs(fb0[n] - fb1[n]) * 100.0f;
      float s = wb * bp;
      float t1 = wl * least;
      s = s + t1;
      float t2 = wm * most;
      s = s + t2;
      float t3 = wba * balanced;
      s = s + t3;
      float pe = pack_epoch[n] == epoch ? pack_val[n] : 0.0f;
      score[n] = s + (stat[n] + pe * bonus);
    }

    // pass B: a heap per (table, class) of the C2 best, its top the worst
    struct HC { float s; int32_t n; };
    auto better = [](const HC& x, const HC& y) {   // x ranks before y
      if (x.s != y.s) return x.s > y.s;
      return x.n < y.n;
    };
    auto push = [&](std::vector<HC>& h, const HC& c) {
      if ((int)h.size() < C2) {
        h.push_back(c);
        std::push_heap(h.begin(), h.end(), better);
      } else if (better(c, h.front())) {
        std::pop_heap(h.begin(), h.end(), better);
        h.back() = c;
        std::push_heap(h.begin(), h.end(), better);
      }
    };
    std::vector<std::vector<HC>> hi(TT), hf(TT);
    for (int t = 0; t < TT; ++t) {
      hi[t].reserve(C2);
      hf[t].reserve(C2);
    }
    for (int n = 0; n < N; ++n) {
      if (!(fi[n] | ff[n])) continue;
      HC c{score[n], n};
      for (int mi = mem_off[n]; mi < mem_off[n + 1]; ++mi) {
        int t = mem_slot[mi];
        if (fi[n]) push(hi[t], c);
        if (ff[n]) push(hf[t], c);
      }
    }

    // the rows, straight from pass A
    gen++;
    packed_rows.clear();
    dirty_rows.clear();
    auto install = [&](std::vector<HC>& h, int t, int base, bool idle_class,
                       int width) {
      std::sort_heap(h.begin(), h.end(), better);
      int cnt = (int)h.size();
      for (int i = 0; i < width; ++i) {
        int k = base + i;
        Row& r = rows[k];
        if (i >= cnt) { r.gidx = -1; continue; }
        int n = h[i].n;
        load_row(k, n, stat);
        r.score = score[n];
        r.fi = fi[n];
        r.ff = ff[n];
        size_t m = (size_t)t * N + n;
        if (rowmap_gen[m] != gen) {
          rowmap_gen[m] = gen;
          rowmap_i[m] = -1;
          rowmap_f[m] = -1;
        }
        (idle_class ? rowmap_i : rowmap_f)[m] = k;
      }
    };
    for (int t = 0; t < TT; ++t) {
      int base = t * STRIDE;
      install(hi[t], t, base, true, C2 + OV);   // the overflow rows dead
      install(hf[t], t, base + C2 + OV, false, C2);
      ov_used[t] = 0;
    }
    table_group = g;
    verified_group = g;
    table_bucket = b;
    touched = 0;
    have_table = true;
    table_pack_clean = placed_since_reset == 0;
  }

  inline bool same_content(int g1, int g2) const {
    if (g1 == g2) return true;
    if (g1 < 0 || g2 < 0) return false;
    if (std::memcmp(&a.pack_bonus[g1], &a.pack_bonus[g2], sizeof(float)))
      return false;
    if (std::memcmp(&a.group_req[(size_t)g1 * R],
                    &a.group_req[(size_t)g2 * R], R * sizeof(float)))
      return false;
    if (std::memcmp(&a.group_mask[(size_t)g1 * N],
                    &a.group_mask[(size_t)g2 * N], N))
      return false;
    if (std::memcmp(&a.group_static[(size_t)g1 * N],
                    &a.group_static[(size_t)g2 * N],
                    (size_t)N * sizeof(float)))
      return false;
    return true;
  }

  // the pack row starts over (the plain loop's pack.zero_())
  void reset_pack() {
    if (placed_since_reset == 0) return;   // every pack is 0 already
    epoch++;
    placed_since_reset = 0;
    if (!have_table) return;
    if (!table_pack_clean) {
      // an untouched node outside the table may have had pack: its
      // score changes, and the dominance with it
      have_table = false;
      return;
    }
    // only placed-on rows had pack; rescore them before the next serve
    dirty_rows.insert(dirty_rows.end(), packed_rows.begin(),
                      packed_rows.end());
    packed_rows.clear();
  }

  // ---- the placement of the step's task on node sel: node state, undo
  // entry, pack, and sel's rows in every table whose domain holds it
  void apply(int sel, bool take_idle, int g, const float* req, float bonus) {
    size_t u = undo.size();
    undo.resize(u + 2 + 2 * (size_t)R);
    std::memcpy(&undo[u], &sel, sizeof(float));
    std::memcpy(&undo[u + 1], &ntasks[sel], sizeof(float));
    for (int r = 0; r < R; ++r) {
      undo[u + 2 + r] = idleT[(size_t)r * N + sel];
      undo[u + 2 + R + r] = futT[(size_t)r * N + sel];
    }
    for (int r = 0; r < R; ++r) {
      if (take_idle) idleT[(size_t)r * N + sel] -= req[r];
      futT[(size_t)r * N + sel] -= req[r];
    }
    ntasks[sel] += 1;
    if (pack_epoch[sel] != epoch) {
      pack_epoch[sel] = epoch;
      pack_val[sel] = 0.0f;
    }
    pack_val[sel] += 1.0f;
    placed_since_reset++;
    const float* stat = &a.group_static[(size_t)g * N];
    for (int mi = mem_off[sel]; mi < mem_off[sel + 1]; ++mi) {
      int t = mem_slot[mi];
      size_t m = (size_t)t * N + sel;
      bool mapped = rowmap_gen[m] == gen;
      int32_t ki = mapped ? rowmap_i[m] : -1;
      int32_t kf = mapped ? rowmap_f[m] : -1;
      if (ki < 0 && kf < 0) {
        if (OV == 0) continue;   // one table: sel was served from it
        if (ov_used[t] >= OV) {  // cannot keep the table complete
          have_table = false;
          continue;
        }
        int k = t * STRIDE + C2 + ov_used[t]++;
        load_row(k, sel, stat);
        row_score(k, req, bonus);
        if (!mapped) {
          rowmap_gen[m] = gen;
          rowmap_f[m] = -1;
        }
        rowmap_i[m] = k;
        continue;
      }
      for (int which = 0; which < 2; ++which) {
        int k = which == 0 ? ki : kf;
        if (k < 0) continue;
        Row& r = rows[k];
        for (int rr = 0; rr < R; ++rr) {
          if (take_idle) r_idle[(size_t)k * R + rr] -= req[rr];
          r_fut[(size_t)k * R + rr] -= req[rr];
        }
        r.ntasks += 1;
        if (r.pepoch != epoch) {
          r.pepoch = epoch;
          r.pack = 0.0f;
        }
        if (r.pack == 0.0f) packed_rows.push_back(k);
        r.pack += 1.0f;
        row_score(k, req, bonus);
      }
    }
    touched++;
  }

  void rollback() {
    rollbacks++;
    const size_t w = 2 + 2 * (size_t)R;
    for (size_t e = undo.size(); e >= w; e -= w) {
      const float* u = &undo[e - w];
      int32_t node, nt;
      std::memcpy(&node, &u[0], sizeof(float));
      std::memcpy(&nt, &u[1], sizeof(float));
      for (int r = 0; r < R; ++r) {
        idleT[(size_t)r * N + node] = u[2 + r];
        futT[(size_t)r * N + node] = u[2 + R + r];
      }
      ntasks[node] = nt;
    }
    have_table = false;   // the next step refreshes
  }

  void run() {
    int32_t pool, job;
    select(&pool, &job);
    int32_t t_off = 0, placed = 0, placed_alloc = 0;
    std::vector<float> placed_res(R, 0.0f);
    for (int32_t step = 0; step < a.T && job >= 0; ++step) {
      int32_t t_idx = a.job_start[job] + t_off;
      t_idx = std::min(std::max(t_idx, 0), a.T - 1);
      const int g = a.task_group[t_idx];
      const int32_t b = a.task_bucket[t_idx];
      const bool valid = a.task_valid[t_idx] && t_off < a.job_ntasks[job];
      if (!(b >= 0 && b == cur_bucket)) reset_pack();
      if (valid) {
        const float* req = &a.group_req[(size_t)g * R];
        const float bonus = a.pack_bonus[g];
        bool content_ok = have_table &&
            (g == table_group || g == verified_group);
        if (have_table && !content_ok && same_content(g, table_group)) {
          verified_group = g;
          content_ok = true;
        }
        if (!content_ok || touched >= C2 || b != table_bucket)
          refresh(g, b, req, bonus);
        for (int32_t k : dirty_rows) row_score(k, req, bonus);
        dirty_rows.clear();
        const int tt = table_of(t_idx);
        // the argmax of the task's table: idle fits first, then future;
        // the highest score, the lowest node index on ties
        int bi = -1, bf = -1;
        float si = 0.0f, sf = 0.0f;
        if (tt >= 0) {
          for (int k = tt * STRIDE, e = k + STRIDE; k < e; ++k) {
            const Row& r = rows[k];
            if (r.gidx < 0) continue;
            if (r.fi && (bi < 0 || r.score > si ||
                         (r.score == si && r.gidx < bi))) {
              bi = r.gidx;
              si = r.score;
            }
            if (r.ff && (bf < 0 || r.score > sf ||
                         (r.score == sf && r.gidx < bf))) {
              bf = r.gidx;
              sf = r.score;
            }
          }
        }
        const int sel = bi >= 0 ? bi : (a.allow_pipeline ? bf : -1);
        if (sel >= 0) {
          const bool pipe = bi < 0;
          apply(sel, !pipe, g, req, bonus);
          placed += 1;
          if (!pipe) placed_alloc += 1;
          for (int r = 0; r < R; ++r) placed_res[r] = placed_res[r] + req[r];
          a.assign[t_idx] = sel;
          a.out_pipelined[t_idx] = pipe ? 1 : 0;
        }
        cur_bucket = b;
      }
      t_off += 1;

      // ---- the job boundary: gang commit or rollback, charges, select
      if (t_off < a.job_ntasks[job]) continue;
      const bool is_ready = a.job_base[job] + placed_alloc >= a.job_min[job];
      const bool is_kept = a.job_base[job] + placed >= a.job_min[job];
      if (is_ready || is_kept) {
        const int q = a.pool_queue[pool], ns = a.pool_ns[pool];
        for (int r = 0; r < R; ++r) {
          q_alloc[(size_t)q * R + r] += placed_res[r];
          ns_alloc[(size_t)ns * R + r] += placed_res[r];
        }
      } else if (placed > 0) {
        rollback();
      }
      undo.clear();
      p_cursor[pool] += 1;
      if (is_ready) ready[job] = 1;
      if (is_kept) kept[job] = 1;
      select(&pool, &job);
      t_off = placed = placed_alloc = 0;
      std::fill(placed_res.begin(), placed_res.end(), 0.0f);
    }

    // tasks of jobs neither committed nor kept are not placed
    for (int32_t t = 0; t < a.T; ++t) {
      int j = std::min(std::max(a.task_job[t], 0), a.J - 1);
      bool ok = a.task_valid[t] && a.J > 0 && (ready[j] || kept[j]);
      if (!ok) { a.assign[t] = -1; a.out_pipelined[t] = 0; }
    }
    std::memcpy(a.out_ready, ready.data(), a.J);
    std::memcpy(a.out_kept, kept.data(), a.J);
    for (int n = 0; n < N; ++n)
      for (int r = 0; r < R; ++r) {
        a.out_idle[(size_t)n * R + r] = idleT[(size_t)r * N + n];
        a.out_future[(size_t)n * R + r] = futT[(size_t)r * N + n];
      }
    std::memcpy(a.out_ntasks, ntasks.data(), (size_t)N * sizeof(int32_t));
    std::memcpy(a.out_q_alloc, q_alloc.data(), q_alloc.size() * sizeof(float));
    std::memcpy(a.out_ns_alloc, ns_alloc.data(),
                ns_alloc.size() * sizeof(float));
    std::memcpy(a.out_p_cursor, p_cursor.data(),
                p_cursor.size() * sizeof(int32_t));
    a.out_stats[0] = refreshes;
    a.out_stats[1] = rollbacks;
  }
};

}  // namespace

// 0 = done; 1 = an argument is out of range (the wrapper checks shapes)
extern "C" int vc_gang_allocate(const Args* args) {
  if (!args || args->T < 0 || args->N <= 0 || args->R < 2 ||
      args->C2 <= 0 || args->J < 0 || args->S < -1 ||
      (args->S >= 0 && (!args->task_slot || !args->slot_ok)))
    return 1;
  for (int32_t t = 0; t < args->T; ++t) {
    args->assign[t] = -1;
    args->out_pipelined[t] = 0;
  }
  std::memset(args->out_ready, 0, args->J);
  std::memset(args->out_kept, 0, args->J);
  Solver s(*args);
  s.run();
  return 0;
}

extern "C" int vc_abi_version() { return 1; }
