// Host engines of the resident text batch (parallel/fleet.DeviceDocBatch):
// the incremental Fugue order engine that gives every row a standing
// 64-bit order key in O(delta) per sync, and the per-doc
// (peer, counter) -> row id map with stage / lookup / commit | abort.
//
// The order and id-map part of the JAX package's native decoder, copied;
// the keys are bit-identical to the port's Python ShadowOrder
// (parallel/order_maintenance.py, the differential oracle).
//
// C ABI only (ctypes binding in loro_tpu_torch/native/__init__.py);
// built with g++ -O3 -shared -fPIC -std=c++17.  Every call works on one
// handle, so calls on different handles may run on threads at once.

#include <cstddef>
#include <cstdint>
#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// Native ShadowOrder: incremental Fugue order maintenance (the exact
// algorithm of parallel/order_maintenance.py, so keys are bit-identical
// — the Python engine is the differential oracle).  State lives behind
// an opaque handle; DeviceDocBatch calls append per sync with the delta
// rows and gets 64-bit order keys back in O(delta).

namespace order {

constexpr int64_t KEY_STEP = 1ll << 20;
// Run continuations take a small low-biased step instead of the gap
// midpoint (mirrors order_maintenance.py RUN_STEP — the two engines
// must stay bit-identical): a typing run consumes L*RUN_STEP of the
// gap instead of halving it L times.
constexpr int64_t RUN_STEP = 1ll << 8;
constexpr int32_t HEAD = -2;

struct Doc {
  std::vector<uint64_t> peer;
  std::vector<int64_t> ctr;
  std::vector<int32_t> prev, next, spine;
  std::vector<int64_t> key;
  int32_t first_row = -1;
  // (row << 1 | side) -> children sorted by (peer, ctr)
  std::unordered_map<uint64_t, std::vector<int32_t>> branches;
  std::vector<int32_t> root_children;
  int64_t renumbers = 0;

  int64_t n() const { return (int64_t)peer.size(); }

  bool sib_less(int32_t a, uint64_t bp, int64_t bc) const {
    return peer[a] != bp ? peer[a] < bp : ctr[a] < bc;
  }

  int32_t last_r_child(int32_t row) const {
    auto it = branches.find(((uint64_t)row << 1) | 1);
    if (it != branches.end() && !it->second.empty()) return it->second.back();
    return spine[row];
  }

  int32_t subtree_last(int32_t row) const {
    int32_t x = row;
    while (true) {
      int32_t nxt = last_r_child(x);
      if (nxt < 0) return x;
      x = nxt;
    }
  }

  int32_t subtree_first(int32_t row) const {
    int32_t x = row;
    while (true) {
      auto it = branches.find(((uint64_t)x << 1) | 0);
      if (it == branches.end() || it->second.empty()) return x;
      x = it->second.front();
    }
  }

  void splice_after(int32_t pred, int32_t row) {
    int32_t succ;
    if (pred == HEAD) {
      succ = first_row;
      first_row = row;
    } else {
      succ = next[pred];
      next[pred] = row;
    }
    prev[row] = pred;
    next[row] = succ;
    if (succ >= 0) prev[succ] = row;
  }

  bool assign_key(int32_t row, bool run) {
    int32_t p = prev[row], s = next[row];
    if (p < 0 && s < 0) key[row] = 0;
    else if (p < 0) key[row] = key[s] - KEY_STEP;
    else if (s < 0) key[row] = key[p] + KEY_STEP;
    else {
      int64_t lo = key[p], hi = key[s];
      if (hi - lo < 2) return false;
      int64_t step = (hi - lo) / 2;
      if (run && step > RUN_STEP) step = RUN_STEP;
      key[row] = lo + step;
    }
    return true;
  }

  void renumber() {
    renumbers++;
    int64_t k = 0;
    int32_t x = first_row;
    while (x >= 0) {
      key[x] = k;
      k += KEY_STEP;
      x = next[x];
    }
  }

  std::vector<int32_t>& sibling_list(int32_t parent_row, int32_t side) {
    if (parent_row < 0) return root_children;
    uint64_t bk = ((uint64_t)parent_row << 1) | (uint64_t)side;
    auto it = branches.find(bk);
    if (it == branches.end()) {
      auto& lst = branches[bk];
      if (side == 1) {
        int32_t sp = spine[parent_row];
        if (sp >= 0) {
          lst.push_back(sp);
          spine[parent_row] = -1;  // now tracked in branches
        }
      }
      return lst;  // node-stable reference
    }
    return it->second;
  }

  // Returns true on the run-continuation fast path (caller assigns a
  // low-biased key so runs don't bisect the gap).
  bool place(int32_t parent_row, int32_t side, int32_t row) {
    // run-continuation fast path
    if (parent_row >= 0 && side == 1 && spine[parent_row] < 0 &&
        branches.find(((uint64_t)parent_row << 1) | 1) == branches.end() &&
        peer[parent_row] == peer[row] && ctr[parent_row] == ctr[row] - 1) {
      spine[parent_row] = row;
      splice_after(parent_row, row);
      return true;
    }
    auto& sibs = sibling_list(parent_row, side);
    uint64_t mp = peer[row];
    int64_t mc = ctr[row];
    size_t i = 0;
    while (i < sibs.size() && sib_less(sibs[i], mp, mc)) i++;
    sibs.insert(sibs.begin() + i, row);
    if (side == 1 || parent_row < 0) {
      int32_t pred;
      if (i == 0) pred = parent_row >= 0 ? parent_row : HEAD;
      else pred = subtree_last(sibs[i - 1]);
      splice_after(pred, row);
    } else {
      if (i > 0) {
        splice_after(subtree_last(sibs[i - 1]), row);
      } else {
        int32_t nxt = sibs.size() > i + 1 ? sibs[i + 1] : -1;
        int32_t old_first = nxt >= 0 ? subtree_first(nxt) : parent_row;
        splice_after(prev[old_first], row);
      }
    }
    return false;
  }
};

}  // namespace order

extern "C" {

void* loro_order_new() { return new order::Doc(); }

void loro_order_free(void* h) { delete (order::Doc*)h; }

long long loro_order_nrows(void* h) { return ((order::Doc*)h)->n(); }

long long loro_order_renumbers(void* h) { return ((order::Doc*)h)->renumbers; }

void loro_order_all_keys(void* h, int64_t* out) {
  auto* d = (order::Doc*)h;
  for (int64_t i = 0; i < d->n(); i++) out[i] = d->key[i];
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native id map: per-doc (peer u64, counter i64) -> device row.  The
// resident batches resolve cross-epoch parents/deletes and register
// every ingested row here (per-row Python dict traffic would dominate
// the host's ingest time).  Staging mirrors the
// Python-side contract: stage -> lookup (staged shadows main) ->
// commit | abort, so a capacity error leaves the map untouched.

namespace idmap {

struct Key {
  uint64_t peer;
  int64_t ctr;
  bool operator==(const Key& o) const { return peer == o.peer && ctr == o.ctr; }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t x = k.peer ^ (uint64_t)k.ctr * 0x9E3779B97F4A7C15ull;
    x ^= x >> 30; x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27; x *= 0x94D049BB133111EBull;
    return (size_t)(x ^ (x >> 31));
  }
};

struct Map {
  std::unordered_map<Key, int32_t, KeyHash> main, staged;
};

}  // namespace idmap

extern "C" {

void* loro_idmap_new() { return new idmap::Map(); }
void loro_idmap_free(void* h) { delete (idmap::Map*)h; }

long long loro_idmap_len(void* h) {
  return (long long)((idmap::Map*)h)->main.size();
}

// Committed inserts with explicit rows (import_state, fallback-path
// overlay commits).
void loro_idmap_insert(void* h, long long n, const uint64_t* peer,
                       const int64_t* ctr, const int32_t* rows) {
  auto* m = (idmap::Map*)h;
  m->main.reserve(m->main.size() + (size_t)n);
  for (long long i = 0; i < n; i++) m->main[{peer[i], ctr[i]}] = rows[i];
}

// Stage n new rows at base_row..base_row+n-1 (visible to lookups,
// not committed).
void loro_idmap_stage(void* h, long long n, const uint64_t* peer,
                      const int64_t* ctr, int32_t base_row) {
  auto* m = (idmap::Map*)h;
  m->staged.reserve(m->staged.size() + (size_t)n);
  for (long long i = 0; i < n; i++)
    m->staged[{peer[i], ctr[i]}] = base_row + (int32_t)i;
}

void loro_idmap_commit(void* h) {
  auto* m = (idmap::Map*)h;
  m->main.reserve(m->main.size() + m->staged.size());
  for (auto& kv : m->staged) m->main[kv.first] = kv.second;
  m->staged.clear();
}

void loro_idmap_abort(void* h) { ((idmap::Map*)h)->staged.clear(); }

// Batch lookup, staged-first (matches the overlay-then-idmap order of
// the Python paths); -1 = missing.
void loro_idmap_lookup(void* h, long long n, const uint64_t* peer,
                       const int64_t* ctr, int32_t* out) {
  auto* m = (idmap::Map*)h;
  for (long long i = 0; i < n; i++) {
    idmap::Key k{peer[i], ctr[i]};
    auto it = m->staged.find(k);
    if (it == m->staged.end()) {
      it = m->main.find(k);
      if (it == m->main.end()) { out[i] = -1; continue; }
    }
    out[i] = it->second;
  }
}

long long loro_idmap_get(void* h, uint64_t peer, int64_t ctr) {
  auto* m = (idmap::Map*)h;
  idmap::Key k{peer, ctr};
  auto it = m->staged.find(k);
  if (it == m->staged.end()) {
    it = m->main.find(k);
    if (it == m->main.end()) return -1;
  }
  return it->second;
}

}  // extern "C"

extern "C" {

// Place k rows (parent_row, side, peer, ctr) at indexes base_row..;
// fills out_keys.  Returns 0, 1 when a renumber happened (caller
// re-uploads all keys), or -1 on a non-contiguous base.
long long loro_order_append(void* h, long long k, const int32_t* parent,
                            const int32_t* side, const uint64_t* peer,
                            const int64_t* ctr, long long base_row,
                            int64_t* out_keys) {
  auto* d = (order::Doc*)h;
  if (base_row != d->n()) return -1;
  bool renumbered = false;
  for (long long j = 0; j < k; j++) {
    int32_t row = (int32_t)(base_row + j);
    d->peer.push_back(peer[j]);
    d->ctr.push_back(ctr[j]);
    d->prev.push_back(order::HEAD);
    d->next.push_back(-1);
    d->spine.push_back(-1);
    d->key.push_back(0);
    bool run = d->place(parent[j], side[j], row);
    if (!d->assign_key(row, run)) {
      d->renumber();
      renumbered = true;
    }
    out_keys[j] = d->key[row];
  }
  return renumbered ? 1 : 0;
}

}  // extern "C"
