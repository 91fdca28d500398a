// Native payload -> element-table explode for the port's text ingest:
// parses a binary updates payload (loro_tpu_torch/codec/binary.py has
// the layout: LEB128/zigzag varints, peer/key/container dictionaries,
// change meta, per-op payloads) and writes the element columns of one
// sequence container (parent row, side, peer index, counter, deleted,
// codepoint) straight into caller-owned arrays.
//
// The sequence part of the JAX package's native decoder, copied: Reader,
// skip_value, the (peer, counter) -> row maps (RowTable, and IdMap when
// RowTable's budget is exceeded), strict UTF-8, the prelude and op
// skipping, the two-pass explode, and the resident batch's delta
// explode (rows whose parents lie in earlier payloads come back as
// (peer index, counter) pairs, deletes as raw spans), its style-anchor
// metadata pass and its delete count; the map explode (every map set
// and delete with its value's byte offset); and the tree explode (every
// TreeMove of one container, its position as a byte range); and the
// movable-list explode (slots, sets with value offsets, delete spans),
// one-shot and delta.  The order engine and id map are in order_idmap.cpp.
//
// C ABI only (ctypes binding in loro_tpu_torch/native/__init__.py);
// built with g++ -O3 -shared -fPIC -std=c++17.

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint8_t u8() {
    if (p >= end) { ok = false; return 0; }
    return *p++;
  }
  uint64_t varint() {
    uint64_t v = 0; int shift = 0;
    while (true) {
      if (p >= end || shift > 63) { ok = false; return 0; }
      uint8_t b = *p++;
      v |= (uint64_t)(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
    }
  }
  int64_t zigzag() {
    uint64_t v = varint();
    return (v & 1) ? -(int64_t)((v + 1) >> 1) : (int64_t)(v >> 1);
  }
  uint64_t u64le() {
    if (end - p < 8) { ok = false; return 0; }
    uint64_t v; std::memcpy(&v, p, 8); p += 8; return v;
  }
  double f64() {
    if (end - p < 8) { ok = false; return 0; }
    double v; std::memcpy(&v, p, 8); p += 8; return v;
  }
  bool skip_bytes() {
    uint64_t n = varint();
    // compare against remaining length, never `p + n` (pointer overflow
    // on crafted huge lengths would wrap past `end`)
    if (!ok || n > (uint64_t)(end - p)) { ok = false; return false; }
    p += n; return true;
  }
  const uint8_t* bytes(uint64_t* n_out) {
    uint64_t n = varint();
    if (!ok || n > (uint64_t)(end - p)) { ok = false; return nullptr; }
    const uint8_t* q = p; p += n; *n_out = n; return q;
  }
};

// op kind tags (binary.py)
enum { K_MAP_SET = 0, K_MAP_DEL, K_INSERT_TEXT, K_INSERT_VALUES,
       K_INSERT_ANCHOR, K_DELETE, K_TREE, K_COUNTER, K_MSET, K_MMOVE,
       K_UNKNOWN };
// value tags
enum { VNULL = 0, VTRUE, VFALSE, VINT, VF64, VSTR, VBYTES, VLIST, VMAP, VCID };
enum { PT_NONE = 0, PT_ID = 1, PT_RUNCONT = 2 };

bool skip_value(Reader& r) {
  switch (r.u8()) {
    case VNULL: case VTRUE: case VFALSE: return r.ok;
    case VINT: r.zigzag(); return r.ok;
    case VF64: r.f64(); return r.ok;
    case VSTR: case VBYTES: return r.skip_bytes();
    case VLIST: {
      uint64_t n = r.varint();
      for (uint64_t i = 0; i < n && r.ok; i++) skip_value(r);
      return r.ok;
    }
    case VMAP: {
      uint64_t n = r.varint();
      for (uint64_t i = 0; i < n && r.ok; i++) { r.skip_bytes(); skip_value(r); }
      return r.ok;
    }
    case VCID: r.varint(); return r.ok;
    default: r.ok = false; return false;
  }
}

struct ChangeMeta;

// open-addressing hash map: (peer_idx, counter) -> element row
struct IdMap {
  std::vector<uint64_t> keys;
  std::vector<int32_t> vals;
  uint64_t mask;
  explicit IdMap(size_t n) {
    size_t cap = 16;
    while (cap < n * 2) cap <<= 1;
    keys.assign(cap, ~0ull);
    vals.assign(cap, -1);
    mask = cap - 1;
  }
  IdMap(uint64_t, const std::vector<ChangeMeta>&, size_t n)
      : IdMap(n > 16 ? n : 16) {}
  static uint64_t mix(uint64_t k) {
    k ^= k >> 33; k *= 0xff51afd7ed558ccdULL; k ^= k >> 33;
    k *= 0xc4ceb9fe1a85ec53ULL; k ^= k >> 33; return k;
  }
  void put(uint64_t k, int32_t v) {
    uint64_t i = mix(k) & mask;
    while (keys[i] != ~0ull && keys[i] != k) i = (i + 1) & mask;
    keys[i] = k; vals[i] = v;
  }
  int32_t get(uint64_t k) const {
    uint64_t i = mix(k) & mask;
    while (keys[i] != ~0ull) {
      if (keys[i] == k) return vals[i];
      i = (i + 1) & mask;
    }
    return -1;
  }
  bool overflow() const { return false; }
};

inline uint64_t idkey(uint32_t peer_idx, int64_t counter) {
  return ((uint64_t)peer_idx << 40) | (uint64_t)(counter & 0xffffffffffLL);
}

struct ChangeMeta {
  uint32_t peer_idx;
  int64_t ctr;
  int64_t lamport;
  uint64_t n_ops;
};

// Direct-address (peer, counter) -> row table: causal payloads have
// near-dense insert counters per peer, so idkey lookups become plain
// array loads (~2x on the 182k-row trace vs the open-addressing map,
// whose random probes miss cache).  Per-peer vectors grow on demand;
// a global entry budget guards against adversarial sparse counters
// (huge delete spans between inserts) — on overflow the caller falls
// back to the IdMap path, so behavior is identical on any input.
struct RowTable {
  std::vector<std::vector<int32_t>> t;
  std::vector<uint64_t> base;  // 40-bit masked, matching idkey()
  size_t total = 0, budget;
  bool over = false;
  RowTable(uint64_t n_peers, const std::vector<ChangeMeta>& metas,
           size_t n_elems);
  // index math in uint64: crafted payloads can carry counters anywhere
  // in the zigzag range, and signed subtraction would be UB; a wrapped
  // huge index simply trips the budget -> IdMap fallback
  void put(uint64_t key, int32_t row) {
    uint32_t p = (uint32_t)(key >> 40);
    uint64_t i = (key & 0xffffffffffULL) - base[p];
    auto& v = t[p];
    if (i >= v.size()) {
      if (i >= budget) { over = true; return; }
      size_t ns = (size_t)i + 1 + ((size_t)i >> 1) + 64;
      if (total + (ns - v.size()) > budget) { over = true; return; }
      total += ns - v.size();
      v.resize(ns, -1);
    }
    v[(size_t)i] = row;
  }
  int32_t get(uint64_t key) const {
    uint32_t p = (uint32_t)(key >> 40);
    if (p >= t.size()) return -1;
    uint64_t i = (key & 0xffffffffffULL) - base[p];
    if (i >= t[p].size()) return -1;
    return t[p][(size_t)i];
  }
  bool overflow() const { return over; }
};

// test hook: force a tiny budget so the IdMap fallback path is
// exercisable from the differential suite (0 = no override)
long long g_rowtable_budget_override = 0;

inline RowTable::RowTable(uint64_t n_peers,
                          const std::vector<ChangeMeta>& metas,
                          size_t n_elems)
    : budget(g_rowtable_budget_override > 0
                 ? (size_t)g_rowtable_budget_override
                 : n_elems * 8 + (1u << 20)) {
  t.resize(n_peers);
  base.assign(n_peers, ~0ull);
  for (auto& m : metas) {
    uint64_t c = (uint64_t)m.ctr & 0xffffffffffULL;
    if (c < base[m.peer_idx]) base[m.peer_idx] = c;
  }
}

// Strict UTF-8: validates continuation prefixes, rejects overlong
// encodings, surrogates, and > U+10FFFF (a corrupted-but-CRC-valid
// payload must fail decode, not produce wrong codepoints).  Returns
// bytes consumed, or -1 on malformed input.
inline int decode_utf8_cp(const uint8_t* s, uint64_t nb, uint64_t i, uint32_t* out) {
  uint8_t b0 = s[i];
  uint32_t cp; int extra;
  if (b0 < 0x80) { cp = b0; extra = 0; }
  else if ((b0 & 0xe0) == 0xc0) { cp = b0 & 0x1f; extra = 1; }
  else if ((b0 & 0xf0) == 0xe0) { cp = b0 & 0x0f; extra = 2; }
  else if ((b0 & 0xf8) == 0xf0) { cp = b0 & 0x07; extra = 3; }
  else return -1;
  if (i + (uint64_t)extra >= nb && extra > 0) return -1;
  for (int e = 1; e <= extra; e++) {
    if ((s[i + e] & 0xc0) != 0x80) return -1;
    cp = (cp << 6) | (s[i + e] & 0x3f);
  }
  static const uint32_t min_cp[4] = {0, 0x80, 0x800, 0x10000};
  if (extra > 0 && cp < min_cp[extra]) return -1;          // overlong
  if (cp >= 0xd800 && cp <= 0xdfff) return -1;             // surrogate
  if (cp > 0x10ffff) return -1;
  *out = cp;
  return extra + 1;
}

// Parse header tables + change meta.  Returns false on malformed input.
bool parse_prelude(Reader& r, uint64_t* n_peers, std::vector<int32_t>& cid_types,
                   std::vector<ChangeMeta>& metas, uint64_t* n_keys_out = nullptr) {
  *n_peers = r.varint();
  if (!r.ok || *n_peers > 1u << 24) return false;
  for (uint64_t i = 0; i < *n_peers; i++) r.u64le();
  uint64_t n_keys = r.varint();
  if (!r.ok || n_keys > 1u << 26) return false;
  if (n_keys_out) *n_keys_out = n_keys;
  for (uint64_t i = 0; i < n_keys; i++)
    if (!r.skip_bytes()) return false;
  uint64_t n_cids = r.varint();
  if (!r.ok || n_cids > 1u << 26) return false;
  cid_types.resize(n_cids);
  for (uint64_t i = 0; i < n_cids; i++) {
    uint8_t b = r.u8();
    cid_types[i] = b & 0x7f;
    if (b & 0x80) {
      if (!r.skip_bytes()) return false;  // root name
    } else {
      r.varint(); r.zigzag();  // peer idx + counter
    }
  }
  uint64_t n_changes = r.varint();
  if (!r.ok || n_changes > 1u << 28) return false;
  metas.resize(n_changes);
  for (uint64_t i = 0; i < n_changes; i++) {
    uint64_t pidx = r.varint();
    if (!r.ok || pidx >= *n_peers) return false;  // wire index must hit the peer table
    metas[i].peer_idx = (uint32_t)pidx;
    metas[i].ctr = r.zigzag();
    metas[i].lamport = r.zigzag();
    r.zigzag();  // timestamp delta
    uint64_t nd = r.varint();
    if (!r.ok || nd > 1u << 20) return false;
    for (uint64_t j = 0; j < nd; j++) { r.varint(); r.zigzag(); }
    if (r.u8()) { if (!r.skip_bytes()) return false; }  // message
    metas[i].n_ops = r.varint();
    if (!r.ok) return false;
  }
  return r.ok;
}

// Skip one op payload (after container idx + kind already consumed),
// for ops not on the target container.  `atoms` receives the counter
// span the op consumes.
bool skip_op(Reader& r, uint8_t kind, int64_t* atoms) {
  *atoms = 1;
  switch (kind) {
    case K_MAP_SET: r.varint(); return skip_value(r);
    case K_MAP_DEL: r.varint(); return r.ok;
    case K_INSERT_TEXT: {
      uint8_t tag = r.u8();
      if (tag == PT_ID) { r.varint(); r.zigzag(); }
      r.u8();  // side
      uint64_t n; const uint8_t* s = r.bytes(&n);
      if (!r.ok) return false;
      // count codepoints for atom length
      int64_t cp = 0;
      for (uint64_t i = 0; i < n; i++) if ((s[i] & 0xc0) != 0x80) cp++;
      *atoms = cp;
      return true;
    }
    case K_INSERT_VALUES: {
      uint8_t tag = r.u8();
      if (tag == PT_ID) { r.varint(); r.zigzag(); }
      r.u8();
      uint64_t n = r.varint();
      for (uint64_t i = 0; i < n && r.ok; i++) skip_value(r);
      *atoms = (int64_t)n;
      return r.ok;
    }
    case K_INSERT_ANCHOR: {
      uint8_t tag = r.u8();
      if (tag == PT_ID) { r.varint(); r.zigzag(); }
      r.u8();
      r.varint();  // key
      if (!skip_value(r)) return false;
      r.u8(); r.varint();
      return r.ok;
    }
    case K_DELETE: {
      uint64_t n = r.varint();
      for (uint64_t i = 0; i < n && r.ok; i++) { r.varint(); r.zigzag(); r.varint(); }
      return r.ok;
    }
    case K_TREE: {
      r.varint(); r.zigzag();
      uint8_t flags = r.u8();
      if (flags & 4) { r.varint(); r.zigzag(); }
      if (flags & 8) { if (!r.skip_bytes()) return false; }
      return r.ok;
    }
    case K_COUNTER: r.f64(); return r.ok;
    case K_MSET: r.varint(); r.zigzag(); return skip_value(r);
    case K_MMOVE: {
      r.varint(); r.zigzag();
      uint8_t tag = r.u8();
      if (tag == PT_ID) { r.varint(); r.zigzag(); }
      r.u8();
      return r.ok;
    }
    case K_UNKNOWN: r.varint(); return r.skip_bytes();
    default: return false;
  }
}

struct DelSpan { uint32_t peer_idx; int64_t start, end; };

}  // namespace

template <class MapT>
static long long explode_seq_impl(const uint8_t* buf, long long len,
                                  int target_cid,
                                  int32_t* out_parent, int32_t* out_side,
                                  int32_t* out_peer, int32_t* out_counter,
                                  uint8_t* out_deleted, int32_t* out_content,
                                  long long n_elems) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  MapT map(n_peers, metas, (size_t)(n_elems > 0 ? n_elems : 0));
  std::vector<DelSpan> dels;
  long long row = 0;
  int32_t value_base = 0;
  for (auto& m : metas) {
    int64_t ctr = m.ctr;
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      if ((long long)cidx != target_cid) {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
        continue;
      }
      if (kind == K_INSERT_TEXT || kind == K_INSERT_VALUES) {
        uint8_t ptag = r.u8();
        uint32_t p_peer = 0; int64_t p_ctr = 0;
        if (ptag == PT_ID) {
          uint64_t pi = r.varint();
          if (!r.ok || pi >= n_peers) return -1;
          p_peer = (uint32_t)pi; p_ctr = r.zigzag();
        }
        uint8_t side = r.u8();
        // resolve first element's parent
        int32_t parent_row;
        if (ptag == PT_NONE) parent_row = -1;
        else if (ptag == PT_RUNCONT) {
          parent_row = map.get(idkey(m.peer_idx, ctr - 1));
          if (parent_row < 0) return map.overflow() ? -2 : -1;
        } else {
          parent_row = map.get(idkey(p_peer, p_ctr));
          if (parent_row < 0) return map.overflow() ? -2 : -1;
        }
        if (kind == K_INSERT_TEXT) {
          uint64_t nb; const uint8_t* s = r.bytes(&nb);
          if (!r.ok) return -1;
          // utf8 -> codepoints, one element per codepoint
          uint64_t i = 0; int64_t j = 0;
          while (i < nb) {
            uint32_t cp;
            int used = decode_utf8_cp(s, nb, i, &cp);
            if (used < 0) return -1;
            i += used;
            if (row >= n_elems) return -1;
            out_parent[row] = (j == 0) ? parent_row : (int32_t)(row - 1);
            out_side[row] = (j == 0) ? side : 1;
            out_peer[row] = (int32_t)m.peer_idx;
            out_counter[row] = (int32_t)(ctr + j);
            out_deleted[row] = 0;
            out_content[row] = (int32_t)cp;
            map.put(idkey(m.peer_idx, ctr + j), (int32_t)row);
            row++; j++;
          }
          ctr += j;
        } else {
          uint64_t n = r.varint();
          for (uint64_t j = 0; j < n; j++) {
            if (!skip_value(r)) return -1;
            if (row >= n_elems) return -1;
            out_parent[row] = (j == 0) ? parent_row : (int32_t)(row - 1);
            out_side[row] = (j == 0) ? side : 1;
            out_peer[row] = (int32_t)m.peer_idx;
            out_counter[row] = (int32_t)(ctr + (int64_t)j);
            out_deleted[row] = 0;
            out_content[row] = value_base++;
            map.put(idkey(m.peer_idx, ctr + (int64_t)j), (int32_t)row);
            row++;
          }
          ctr += (int64_t)n;
        }
      } else if (kind == K_DELETE) {
        uint64_t n = r.varint();
        for (uint64_t i = 0; i < n && r.ok; i++) {
          DelSpan d;
          uint64_t dpi = r.varint();
          if (!r.ok || dpi >= n_peers) return -1;
          d.peer_idx = (uint32_t)dpi;
          d.start = r.zigzag();
          d.end = d.start + (int64_t)r.varint();
          dels.push_back(d);
        }
        if (!r.ok) return -1;
        ctr += 1;
      } else {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
      }
    }
  }
  for (auto& d : dels) {
    for (int64_t c = d.start; c < d.end; c++) {
      int32_t i = map.get(idkey(d.peer_idx, c));
      if (i >= 0) out_deleted[i] = 1;
    }
  }
  if (map.overflow()) return -2;  // direct table blew its budget
  return row;
}


extern "C" {

// test-only: force a tiny RowTable budget (0 = default) so the
// IdMap fallback is exercisable from the differential suite
void loro_set_rowtable_budget(long long b) { g_rowtable_budget_override = b; }


// Pass 1: count elements of the target container (by cid index).
// Returns element count, or -1 on malformed input.
long long loro_count_seq_elements(const uint8_t* buf, long long len,
                                  int target_cid) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  long long total = 0;
  for (auto& m : metas) {
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      int64_t atoms = 1;
      if (!skip_op(r, kind, &atoms)) return -1;
      if ((long long)cidx == target_cid &&
          (kind == K_INSERT_TEXT || kind == K_INSERT_VALUES)) {
        total += atoms;
      }
    }
  }
  return total;
}

// Pass 2: fill element columns for the target container.
// out_* arrays must hold n_elems entries (from pass 1).
// out_content: codepoints for text inserts; value ops get ascending ids
// starting at `value_base` (caller resolves values Python-side).
// Returns number of elements written, or -1 on malformed input /
// unresolvable parent reference.
long long loro_explode_seq(const uint8_t* buf, long long len, int target_cid,
                           int32_t* out_parent, int32_t* out_side,
                           int32_t* out_peer, int32_t* out_counter,
                           uint8_t* out_deleted, int32_t* out_content,
                           long long n_elems) {
  long long rc = explode_seq_impl<RowTable>(
      buf, len, target_cid, out_parent, out_side, out_peer, out_counter,
      out_deleted, out_content, n_elems);
  if (rc != -2) return rc;
  // sparse-counter payload blew the direct table's budget: redo with
  // the open-addressing map — outputs are fully rewritten
  return explode_seq_impl<IdMap>(
      buf, len, target_cid, out_parent, out_side, out_peer, out_counter,
      out_deleted, out_content, n_elems);
}

// Count rows the DELTA explode will emit (chars/values AND style
// anchors — anchors are parentable Fugue nodes and must enter the
// resident id map).
long long loro_count_seq_delta_rows(const uint8_t* buf, long long len,
                                    int target_cid) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  long long total = 0;
  for (auto& m : metas) {
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      int64_t atoms = 1;
      if (!skip_op(r, kind, &atoms)) return -1;
      if ((long long)cidx == target_cid &&
          (kind == K_INSERT_TEXT || kind == K_INSERT_VALUES || kind == K_INSERT_ANCHOR)) {
        total += atoms;
      }
    }
  }
  return total;
}

// Pass 2 (incremental variant): like loro_explode_seq but parents that
// don't resolve inside this payload are reported as (peer_idx, counter)
// pairs with out_parent = -2, for host-side resolution against the
// resident batch's id map; deletes are returned as spans instead of
// folded, for the same reason; style anchors emit rows with
// out_content = -1.  out_del_* must hold n_del_max entries (from
// loro_count_seq_deletes).  Returns rows written or -1.
long long loro_explode_seq_delta(const uint8_t* buf, long long len, int target_cid,
                                 int32_t* out_parent, int32_t* out_side,
                                 int32_t* out_peer, int32_t* out_counter,
                                 int32_t* out_content,
                                 int32_t* out_ext_peer, int64_t* out_ext_ctr,
                                 long long n_elems,
                                 int32_t* out_del_peer, int64_t* out_del_start,
                                 int64_t* out_del_end, long long n_del_max,
                                 long long* n_del_out) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  IdMap map((size_t)(n_elems > 16 ? n_elems : 16));
  long long row = 0, n_del = 0;
  int32_t value_base = 0;
  for (auto& m : metas) {
    int64_t ctr = m.ctr;
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      if ((long long)cidx != target_cid) {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
        continue;
      }
      if (kind == K_INSERT_TEXT || kind == K_INSERT_VALUES || kind == K_INSERT_ANCHOR) {
        uint8_t ptag = r.u8();
        uint32_t p_peer = 0; int64_t p_ctr = 0;
        if (ptag == PT_ID) {
          uint64_t pi = r.varint();
          if (!r.ok || pi >= n_peers) return -1;
          p_peer = (uint32_t)pi; p_ctr = r.zigzag();
        }
        uint8_t side = r.u8();
        int32_t parent_row;
        uint32_t ext_peer = 0; int64_t ext_ctr = -1;
        if (ptag == PT_NONE) parent_row = -1;
        else if (ptag == PT_RUNCONT) {
          parent_row = map.get(idkey(m.peer_idx, ctr - 1));
          if (parent_row < 0) { parent_row = -2; ext_peer = m.peer_idx; ext_ctr = ctr - 1; }
        } else {
          parent_row = map.get(idkey(p_peer, p_ctr));
          if (parent_row < 0) { parent_row = -2; ext_peer = p_peer; ext_ctr = p_ctr; }
        }
        auto emit = [&](int64_t j, uint32_t cp) -> bool {
          if (row >= n_elems) return false;
          out_parent[row] = (j == 0) ? parent_row : (int32_t)(row - 1);
          out_side[row] = (j == 0) ? side : 1;
          out_peer[row] = (int32_t)m.peer_idx;
          out_counter[row] = (int32_t)(ctr + j);
          out_content[row] = (int32_t)cp;
          out_ext_peer[row] = (j == 0 && parent_row == -2) ? (int32_t)ext_peer : -1;
          out_ext_ctr[row] = (j == 0 && parent_row == -2) ? ext_ctr : -1;
          map.put(idkey(m.peer_idx, ctr + j), (int32_t)row);
          row++;
          return true;
        };
        if (kind == K_INSERT_ANCHOR) {
          // key-idx, value, is_start, info — anchors are zero-width but
          // parentable: emit a content=-1 row (the order solve ignores
          // it; the id map needs it)
          r.varint();
          if (!skip_value(r)) return -1;
          r.u8(); r.varint();
          if (!r.ok) return -1;
          if (!emit(0, (uint32_t)-1)) return -1;
          ctr += 1;
        } else if (kind == K_INSERT_TEXT) {
          uint64_t nb; const uint8_t* s = r.bytes(&nb);
          if (!r.ok) return -1;
          uint64_t i = 0; int64_t j = 0;
          while (i < nb) {
            uint32_t cp;
            int used = decode_utf8_cp(s, nb, i, &cp);
            if (used < 0) return -1;
            i += used;
            if (!emit(j, cp)) return -1;
            j++;
          }
          ctr += j;
        } else {
          uint64_t n = r.varint();
          for (uint64_t j = 0; j < n; j++) {
            if (!skip_value(r)) return -1;
            if (!emit((int64_t)j, (uint32_t)value_base++)) return -1;
          }
          ctr += (int64_t)n;
        }
      } else if (kind == K_DELETE) {
        uint64_t n = r.varint();
        for (uint64_t i = 0; i < n && r.ok; i++) {
          uint64_t dpi = r.varint();
          if (!r.ok || dpi >= n_peers) return -1;
          uint32_t dp = (uint32_t)dpi;
          int64_t ds = r.zigzag();
          int64_t dl = (int64_t)r.varint();
          if (n_del >= n_del_max) return -1;
          out_del_peer[n_del] = (int32_t)dp;
          out_del_start[n_del] = ds;
          out_del_end[n_del] = ds + dl;
          n_del++;
        }
        if (!r.ok) return -1;
        ctr += 1;
      } else {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
      }
    }
  }
  *n_del_out = n_del;
  return row;
}

// Style-anchor metadata for a target container, in the SAME row
// numbering as loro_explode_seq_delta (the host pairs anchors to their
// device rows by ordinal).  Per anchor: row ordinal, wire key index,
// value BYTE OFFSET into the payload (decoded lazily host-side, like
// the map explode's winners), lamport, flags (bit0 = is_start).
// Returns anchors written, or -1 on malformed input / n_max overflow.
long long loro_explode_seq_anchor_meta(const uint8_t* buf, long long len,
                                       int target_cid,
                                       int64_t* out_row, int32_t* out_key,
                                       int64_t* out_voffset,
                                       int32_t* out_lamport,
                                       int32_t* out_flags,
                                       long long n_max) {
  Reader r{buf, buf + len};
  uint64_t n_peers, n_keys; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas, &n_keys)) return -1;
  long long row = 0, n_anchor = 0;
  for (auto& m : metas) {
    int64_t ctr = m.ctr;
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      if ((long long)cidx != target_cid) {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
        continue;
      }
      if (kind == K_INSERT_ANCHOR) {
        uint8_t ptag = r.u8();
        if (ptag == PT_ID) { r.varint(); r.zigzag(); }
        r.u8();  // side
        uint64_t key = r.varint();
        if (!r.ok || key >= n_keys) return -1;
        int64_t voff = (int64_t)(r.p - buf);
        if (!skip_value(r)) return -1;
        uint8_t is_start = r.u8();
        r.varint();  // info (expand behavior rides anchor placement)
        if (!r.ok) return -1;
        if (out_row) {  // null outputs = counting pass
          if (n_anchor >= n_max) return -1;
          out_row[n_anchor] = row;
          out_key[n_anchor] = (int32_t)key;
          out_voffset[n_anchor] = voff;
          out_lamport[n_anchor] = (int32_t)(m.lamport + (ctr - m.ctr));
          out_flags[n_anchor] = is_start ? 1 : 0;
        }
        n_anchor++;
        row++;
        ctr += 1;
      } else {
        // every other kind: skip_op's atom count IS the row count for
        // insert kinds (one row per codepoint/value; the main explode
        // already strictly validated this same payload) and deletes
        // emit no rows
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        if (kind == K_INSERT_TEXT || kind == K_INSERT_VALUES) row += atoms;
        ctr += atoms;
      }
    }
  }
  return n_anchor;
}

// Count delete spans for a target container (sizing for the delta API).
long long loro_count_seq_deletes(const uint8_t* buf, long long len, int target_cid) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  long long total = 0;
  for (auto& m : metas) {
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      if ((long long)cidx == target_cid && kind == K_DELETE) {
        // peek span count without consuming twice: parse spans
        uint64_t n = r.varint();
        for (uint64_t i = 0; i < n && r.ok; i++) { r.varint(); r.zigzag(); r.varint(); }
        if (!r.ok) return -1;
        total += (long long)n;
      } else {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
      }
    }
  }
  return total;
}

// Pass 1: count MapSet/MapDel rows in the payload.
long long loro_count_map_ops(const uint8_t* buf, long long len) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  long long total = 0;
  for (auto& m : metas) {
    for (uint64_t k = 0; k < m.n_ops; k++) {
      r.varint();  // container idx
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      int64_t atoms;
      if (!skip_op(r, kind, &atoms)) return -1;
      if (kind == K_MAP_SET || kind == K_MAP_DEL) total++;
    }
  }
  return total;
}

// Pass 2: map-op rows across ALL map containers: (cid_idx, key_idx,
// lamport, peer_idx, value ordinal or -1 for a delete, the value's
// BYTE OFFSET into the payload or -1).  Values are not decoded here:
// the offsets let the caller decode only the LWW winners.
long long loro_explode_map(const uint8_t* buf, long long len,
                           int32_t* out_cid, int32_t* out_key,
                           int32_t* out_lamport, int32_t* out_peer,
                           int32_t* out_value, int64_t* out_voffset,
                           long long n_rows) {
  Reader r{buf, buf + len};
  uint64_t n_peers, n_keys; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas, &n_keys)) return -1;
  long long row = 0;
  int32_t ordinal = 0;
  for (auto& m : metas) {
    int64_t ctr = m.ctr;
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      if (kind == K_MAP_SET || kind == K_MAP_DEL) {
        uint64_t key = r.varint();
        if (!r.ok || cidx >= cid_types.size() || key >= n_keys) return -1;
        int32_t val = -1;
        int64_t voff = -1;
        if (kind == K_MAP_SET) {
          voff = (int64_t)(r.p - buf);
          if (!skip_value(r)) return -1;
          val = ordinal++;
        }
        if (row >= n_rows) return -1;
        out_cid[row] = (int32_t)cidx;
        out_key[row] = (int32_t)key;
        out_lamport[row] = (int32_t)(m.lamport + (ctr - m.ctr));
        out_peer[row] = (int32_t)m.peer_idx;
        out_value[row] = val;
        out_voffset[row] = voff;
        row++;
        ctr += 1;
      } else {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
      }
    }
  }
  return row;
}

// ---------------------------------------------------------------------------
// Tree explode: all TreeMove rows of one container, wire order.
// Columns: lamport, peer_idx (wire), counter, target (peer_idx, ctr),
// flags (1 create | 2 delete | 4 has-parent | 8 has-position), parent
// (peer_idx, ctr; valid when flags&4), position byte range into the
// payload.  Python sorts by (lamport, peer_u64, counter), builds the
// node dictionary, and feeds ops/tree_batch.tree_merge_batch without
// per-op Python objects.  Copied from the JAX package's native codec.
long long loro_count_tree_ops(const uint8_t* buf, long long len, int target_cid) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  long long count = 0;
  for (auto& m : metas) {
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      int64_t atoms;
      if (kind == K_TREE && (long long)cidx == target_cid) count++;
      if (!skip_op(r, kind, &atoms)) return -1;
    }
  }
  return count;
}

long long loro_explode_tree(const uint8_t* buf, long long len, int target_cid,
                            int32_t* out_lamport, int32_t* out_peer,
                            int32_t* out_counter, int32_t* out_tpeer,
                            int32_t* out_tctr, int32_t* out_flags,
                            int32_t* out_ppeer, int32_t* out_pctr,
                            int64_t* out_pos_off, int32_t* out_pos_len,
                            long long n_rows) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  long long row = 0;
  for (auto& m : metas) {
    int64_t ctr = m.ctr;
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      if (kind != K_TREE || (long long)cidx != target_cid) {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
        continue;
      }
      uint64_t tpi = r.varint();
      int64_t tctr = r.zigzag();
      uint8_t flags = r.u8();
      if (!r.ok || tpi >= n_peers) return -1;
      int32_t ppeer = -1; int64_t pctr = 0;
      if (flags & 4) {
        uint64_t ppi = r.varint();
        pctr = r.zigzag();
        if (!r.ok || ppi >= n_peers) return -1;
        ppeer = (int32_t)ppi;
      }
      int64_t pos_off = -1; int32_t pos_len = 0;
      if (flags & 8) {
        uint64_t nb;
        const uint8_t* pb = r.bytes(&nb);
        if (!r.ok) return -1;
        pos_off = (int64_t)(pb - buf);  // offset of the raw bytes
        pos_len = (int32_t)nb;
      }
      if (row >= n_rows) return -1;
      out_lamport[row] = (int32_t)(m.lamport + (ctr - m.ctr));
      out_peer[row] = (int32_t)m.peer_idx;
      out_counter[row] = (int32_t)ctr;
      out_tpeer[row] = (int32_t)tpi;
      out_tctr[row] = (int32_t)tctr;
      out_flags[row] = (int32_t)flags;
      out_ppeer[row] = ppeer;
      out_pctr[row] = (int32_t)pctr;
      out_pos_off[row] = pos_off;
      out_pos_len[row] = pos_len;
      row++;
      ctr += 1;
    }
  }
  return row;
}


// ---------------------------------------------------------------------------
// Movable-list explode: slots (inserts + moves, parent rows resolved
// through an in-payload id map like the seq explode), sets (creation
// values + MSET, value byte offsets — winners decode lazily in
// Python), delete spans.  Returns -1 on malformed input or an
// unresolvable in-payload reference (caller falls back to Python).
// Copied from the JAX package's native codec, in both of its modes:
// the one-shot walk fails on a parent outside the payload; the delta
// walk (s_extpeer / s_extctr given) returns it as row -2 with its
// (peer index, counter) for the resident batch's id maps.
long long loro_count_movable(const uint8_t* buf, long long len, int target_cid,
                             long long* n_slots, long long* n_sets,
                             long long* n_dels) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  long long slots = 0, sets = 0, dels = 0;
  for (auto& m : metas) {
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      bool mine = (long long)cidx == target_cid;
      if (mine && kind == K_MMOVE) slots++;
      else if (mine && kind == K_MSET) sets++;
      else if (mine && kind == K_DELETE) {
        uint64_t n = r.varint();
        for (uint64_t i = 0; i < n && r.ok; i++) { r.varint(); r.zigzag(); r.varint(); }
        if (!r.ok) return -1;
        dels += (long long)n;
        continue;
      }
      int64_t atoms;
      if (!skip_op(r, kind, &atoms)) return -1;
      if (mine && kind == K_INSERT_VALUES) {
        slots += atoms;
        sets += atoms;  // creation values
      }
    }
  }
  *n_slots = slots; *n_sets = sets; *n_dels = dels;
  return 0;
}

}  // extern "C"

static long long movable_walk(const uint8_t* buf, long long len, int target_cid,
                              int32_t* s_parent, int32_t* s_side,
                              int32_t* s_peer, int32_t* s_ctr,
                              int32_t* s_lamport, int32_t* s_epeer,
                              int32_t* s_ectr,
                              int32_t* v_epeer, int32_t* v_ectr,
                              int32_t* v_lamport, int32_t* v_peer,
                              int64_t* v_off,
                              int32_t* d_peer, int64_t* d_start, int64_t* d_end,
                              long long n_slots, long long n_sets,
                              long long n_dels,
                              int32_t* s_extpeer, int64_t* s_extctr) {
  Reader r{buf, buf + len};
  uint64_t n_peers; std::vector<int32_t> cid_types; std::vector<ChangeMeta> metas;
  if (!parse_prelude(r, &n_peers, cid_types, metas)) return -1;
  IdMap map((size_t)(n_slots > 16 ? n_slots : 16));
  // an insert's or move's parent row: -1 at the list's start, else the
  // row of its parent id in the payload, else -2 with the parent's
  // (peer index, counter) in *ext_peer / *ext_ctr
  auto parent_of = [&](const ChangeMeta& m, int64_t ctr, uint8_t ptag,
                       uint32_t p_peer, int64_t p_ctr, uint32_t* ext_peer,
                       int64_t* ext_ctr) -> int32_t {
    if (ptag == PT_NONE) return -1;
    if (ptag == PT_RUNCONT) { p_peer = m.peer_idx; p_ctr = ctr - 1; }
    int32_t row = map.get(idkey(p_peer, p_ctr));
    if (row >= 0) return row;
    *ext_peer = p_peer;
    *ext_ctr = p_ctr;
    return -2;
  };
  long long srow = 0, vrow = 0, drow = 0;
  for (auto& m : metas) {
    int64_t ctr = m.ctr;
    for (uint64_t k = 0; k < m.n_ops; k++) {
      uint64_t cidx = r.varint();
      uint8_t kind = r.u8();
      if (!r.ok) return -1;
      if ((long long)cidx != target_cid) {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
        continue;
      }
      if (kind == K_INSERT_VALUES) {
        uint8_t ptag = r.u8();
        uint32_t p_peer = 0; int64_t p_ctr = 0;
        if (ptag == PT_ID) {
          uint64_t pi = r.varint();
          if (!r.ok || pi >= n_peers) return -1;
          p_peer = (uint32_t)pi; p_ctr = r.zigzag();
        }
        uint8_t side = r.u8();
        uint64_t n = r.varint();
        if (!r.ok) return -1;
        uint32_t ext_peer = 0; int64_t ext_ctr = -1;
        int32_t parent_row = parent_of(m, ctr, ptag, p_peer, p_ctr, &ext_peer, &ext_ctr);
        if (parent_row == -2 && !s_extpeer) return -1;  // one-shot mode: must resolve
        for (uint64_t j = 0; j < n; j++) {
          int64_t voff = (int64_t)(r.p - buf);
          if (!skip_value(r)) return -1;
          if (srow >= n_slots || vrow >= n_sets) return -1;
          s_parent[srow] = (j == 0) ? parent_row : (int32_t)(srow - 1);
          s_side[srow] = (j == 0) ? (int32_t)side : 1;
          s_peer[srow] = (int32_t)m.peer_idx;
          s_ctr[srow] = (int32_t)(ctr + (int64_t)j);
          s_lamport[srow] = (int32_t)(m.lamport + (ctr - m.ctr) + (int64_t)j);
          s_epeer[srow] = (int32_t)m.peer_idx;  // insert: elem id == own id
          s_ectr[srow] = (int32_t)(ctr + (int64_t)j);
          if (s_extpeer) {
            s_extpeer[srow] = (parent_row == -2 && j == 0) ? (int32_t)ext_peer : -1;
            s_extctr[srow] = (parent_row == -2 && j == 0) ? ext_ctr : -1;
          }
          map.put(idkey(m.peer_idx, ctr + (int64_t)j), (int32_t)srow);
          v_epeer[vrow] = (int32_t)m.peer_idx;
          v_ectr[vrow] = (int32_t)(ctr + (int64_t)j);
          v_lamport[vrow] = (int32_t)(m.lamport + (ctr - m.ctr) + (int64_t)j);
          v_peer[vrow] = (int32_t)m.peer_idx;
          v_off[vrow] = voff;
          srow++; vrow++;
        }
        ctr += (int64_t)n;
      } else if (kind == K_MMOVE) {
        uint64_t epi = r.varint();
        int64_t ectr = r.zigzag();
        if (!r.ok || epi >= n_peers) return -1;
        uint8_t ptag = r.u8();
        uint32_t p_peer = 0; int64_t p_ctr = 0;
        if (ptag == PT_ID) {
          uint64_t pi = r.varint();
          if (!r.ok || pi >= n_peers) return -1;
          p_peer = (uint32_t)pi; p_ctr = r.zigzag();
        }
        uint8_t side = r.u8();
        if (!r.ok) return -1;
        uint32_t ext_peer = 0; int64_t ext_ctr = -1;
        int32_t parent_row = parent_of(m, ctr, ptag, p_peer, p_ctr, &ext_peer, &ext_ctr);
        if (parent_row == -2 && !s_extpeer) return -1;
        if (srow >= n_slots) return -1;
        s_parent[srow] = parent_row;
        s_side[srow] = (int32_t)side;
        s_peer[srow] = (int32_t)m.peer_idx;
        s_ctr[srow] = (int32_t)ctr;
        s_lamport[srow] = (int32_t)(m.lamport + (ctr - m.ctr));
        s_epeer[srow] = (int32_t)epi;
        s_ectr[srow] = (int32_t)ectr;
        if (s_extpeer) {
          s_extpeer[srow] = parent_row == -2 ? (int32_t)ext_peer : -1;
          s_extctr[srow] = parent_row == -2 ? ext_ctr : -1;
        }
        map.put(idkey(m.peer_idx, ctr), (int32_t)srow);
        srow++;
        ctr += 1;
      } else if (kind == K_MSET) {
        uint64_t epi = r.varint();
        int64_t ectr = r.zigzag();
        if (!r.ok || epi >= n_peers) return -1;
        int64_t voff = (int64_t)(r.p - buf);
        if (!skip_value(r)) return -1;
        if (vrow >= n_sets) return -1;
        v_epeer[vrow] = (int32_t)epi;
        v_ectr[vrow] = (int32_t)ectr;
        v_lamport[vrow] = (int32_t)(m.lamport + (ctr - m.ctr));
        v_peer[vrow] = (int32_t)m.peer_idx;
        v_off[vrow] = voff;
        vrow++;
        ctr += 1;
      } else if (kind == K_DELETE) {
        uint64_t n = r.varint();
        for (uint64_t i = 0; i < n && r.ok; i++) {
          uint64_t dpi = r.varint();
          if (!r.ok || dpi >= n_peers) return -1;
          int64_t ds = r.zigzag();
          int64_t dl = (int64_t)r.varint();
          if (drow >= n_dels) return -1;
          d_peer[drow] = (int32_t)dpi;
          d_start[drow] = ds;
          d_end[drow] = ds + dl;
          drow++;
        }
        if (!r.ok) return -1;
        ctr += 1;
      } else {
        int64_t atoms;
        if (!skip_op(r, kind, &atoms)) return -1;
        ctr += atoms;
      }
    }
  }
  return srow;
}


extern "C" {

long long loro_explode_movable(const uint8_t* buf, long long len, int target_cid,
                               int32_t* s_parent, int32_t* s_side,
                               int32_t* s_peer, int32_t* s_ctr,
                               int32_t* s_lamport, int32_t* s_epeer,
                               int32_t* s_ectr,
                               int32_t* v_epeer, int32_t* v_ectr,
                               int32_t* v_lamport, int32_t* v_peer,
                               int64_t* v_off,
                               int32_t* d_peer, int64_t* d_start, int64_t* d_end,
                               long long n_slots, long long n_sets,
                               long long n_dels) {
  return movable_walk(buf, len, target_cid, s_parent, s_side, s_peer, s_ctr,
                      s_lamport, s_epeer, s_ectr, v_epeer, v_ectr, v_lamport,
                      v_peer, v_off, d_peer, d_start, d_end, n_slots, n_sets,
                      n_dels, nullptr, nullptr);
}

// Delta variant: parents that do not resolve inside this payload come
// back as s_parent == -2 with (s_extpeer, s_extctr) pairs for host
// resolution against the resident batch's id map (the movable analog
// of loro_explode_seq_delta's ext-ref protocol).
long long loro_explode_movable_delta(const uint8_t* buf, long long len, int target_cid,
                                     int32_t* s_parent, int32_t* s_side,
                                     int32_t* s_peer, int32_t* s_ctr,
                                     int32_t* s_lamport, int32_t* s_epeer,
                                     int32_t* s_ectr,
                                     int32_t* v_epeer, int32_t* v_ectr,
                                     int32_t* v_lamport, int32_t* v_peer,
                                     int64_t* v_off,
                                     int32_t* d_peer, int64_t* d_start, int64_t* d_end,
                                     long long n_slots, long long n_sets,
                                     long long n_dels,
                                     int32_t* s_extpeer, int64_t* s_extctr) {
  return movable_walk(buf, len, target_cid, s_parent, s_side, s_peer, s_ctr,
                      s_lamport, s_epeer, s_ectr, v_epeer, v_ectr, v_lamport,
                      v_peer, v_off, d_peer, d_start, d_end, n_slots, n_sets,
                      n_dels, s_extpeer, s_extctr);
}

}  // extern "C"
