// fcvm_native: mesh ingest + graph preprocessing for fcvm_tpu_torch.
//
// The port's copy of fcvm_tpu/native/fcvm_native.cpp, the native host layer
// replacing the reference's FreeCAD/SMESH mesh queries (source code/
// fcVM.py:122-347): tet10 mesh parsers (Gmsh ASCII v2.2/v4.1, UNV 2411/2412),
// reverse-Cuthill-McKee bandwidth reduction, adjacency counts, and the %.10g
// and tet10-cell formatters of the legacy-VTK export.  Exposed through a plain
// C ABI consumed via ctypes; the Python side keeps pure-numpy versions of
// every entry point beside it.
//
// Build: fcvm_tpu_torch.native.build() compiles it with g++ into
// fcvm_tpu_torch/_build/libfcvm_native.so at first use.

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <queue>
#include <vector>

namespace {

struct MeshData {
  int64_t nn = 0;
  int64_t ne = 0;
  std::vector<double> coords;    // nn * 3
  std::vector<int64_t> elnodes;  // ne * 10, 0-based, fcvm tet10 order
};

// fcvm tet10 midside order: (0-1),(1-2),(0-2),(0-3),(1-3),(2-3).
// Gmsh tet10 midside order: (0-1),(1-2),(0-2),(0-3),(2-3),(1-3)
// -> swap the last two midside slots.
constexpr int kGmshToFcvm[10] = {0, 1, 2, 3, 4, 5, 6, 7, 9, 8};

// UNV FE descriptor 118 (solid parabolic tetrahedron), SDRC node order:
// corner1, mid(1-2), corner2, mid(2-3), corner3, mid(3-1),
// mid(1-4), mid(2-4), mid(3-4), corner4.
// fcvm order: c1 c2 c3 c4, (c1-c2),(c2-c3),(c1-c3),(c1-c4),(c2-c4),(c3-c4).
constexpr int kUnvToFcvm[10] = {0, 4, 1, 5, 2, 6, 7, 8, 9, 3};
// kUnvToFcvm[i] gives the fcvm slot receiving UNV slot i:
//   unv0=c1->0, unv1=m12->4, unv2=c2->1, unv3=m23->5, unv4=c3->2,
//   unv5=m31->6, unv6=m14->7, unv7=m24->8, unv8=m34->9, unv9=c4->3

// One line at a time through C stdio (POSIX getline), the trailing newline
// kept; starts() skips leading blanks.
class LineReader {
 public:
  explicit LineReader(const char* path) : f_(fopen(path, "r")) {}
  ~LineReader() {
    if (f_) fclose(f_);
    free(buf_);
  }
  LineReader(const LineReader&) = delete;
  LineReader& operator=(const LineReader&) = delete;
  bool ok() const { return f_ != nullptr; }
  bool next() { return getline(&buf_, &cap_, f_) >= 0; }
  char* line() { return buf_; }
  bool starts(const char* p) const {
    const char* s = buf_;
    while (*s == ' ' || *s == '\t' || *s == '\r') ++s;
    return strncmp(s, p, strlen(p)) == 0;
  }

 private:
  FILE* f_;
  char* buf_ = nullptr;
  size_t cap_ = 0;
};

// Up to `max` whitespace-separated integers from the start of `s` into
// `out`; returns how many were read.
int parse_ints(const char* s, int64_t* out, int max) {
  int n = 0;
  while (n < max) {
    char* end;
    long long x = strtoll(s, &end, 10);
    if (end == s) break;
    out[n++] = x;
    s = end;
  }
  return n;
}

}  // namespace

extern "C" {

struct FcvmMesh {
  int64_t nn;
  int64_t ne;
  double* coords;
  int64_t* elnodes;
};

static FcvmMesh* wrap(MeshData&& m) {
  auto* out = new FcvmMesh;
  out->nn = m.nn;
  out->ne = m.ne;
  out->coords = static_cast<double*>(malloc(sizeof(double) * m.nn * 3));
  out->elnodes = static_cast<int64_t*>(malloc(sizeof(int64_t) * m.ne * 10));
  memcpy(out->coords, m.coords.data(), sizeof(double) * m.nn * 3);
  memcpy(out->elnodes, m.elnodes.data(), sizeof(int64_t) * m.ne * 10);
  return out;
}

void fcvm_mesh_free(FcvmMesh* m) {
  if (!m) return;
  free(m->coords);
  free(m->elnodes);
  delete m;
}

// ---------------------------------------------------------------------------
// Gmsh ASCII (.msh), versions 2.2 and 4.1, tet10 element type 11.
// ---------------------------------------------------------------------------

FcvmMesh* fcvm_read_gmsh(const char* path) {
  // C stdio with bounds-checked node tags, as the UNV reader below (an
  // iostream reader crashed inside a process that had loaded the port's
  // CUDA extension); a malformed file returns nullptr.
  LineReader f(path);
  if (!f.ok()) return nullptr;
  double version = 0.0;
  MeshData m;
  std::vector<int64_t> tags;  // node tags (gmsh numbering can be sparse)
  std::vector<double> xyz;
  int64_t v[64];

  auto node = [&](char* p, int64_t tag) {
    double x = strtod(p, &p), y = strtod(p, &p), z = strtod(p, &p);
    tags.push_back(tag);
    xyz.push_back(x);
    xyz.push_back(y);
    xyz.push_back(z);
  };
  // append one tet10 from its gmsh node tags; false on an unknown tag
  std::vector<int64_t> tag2idx;
  auto element = [&](const int64_t* nd) {
    int64_t row[10];
    for (int k = 0; k < 10; ++k) {
      if (nd[k] < 0 || nd[k] >= (int64_t)tag2idx.size() || tag2idx[nd[k]] < 0) return false;
      row[kGmshToFcvm[k]] = tag2idx[nd[k]];
    }
    m.elnodes.insert(m.elnodes.end(), row, row + 10);
    ++m.ne;
    return true;
  };

  while (f.next()) {
    if (f.starts("$MeshFormat")) {
      if (!f.next()) return nullptr;
      version = atof(f.line());
    } else if (f.starts("$Nodes")) {
      if (!f.next()) return nullptr;
      if (version < 4.0) {
        if (parse_ints(f.line(), v, 1) < 1) return nullptr;
        for (int64_t i = 0, n = v[0]; i < n; ++i) {
          if (!f.next()) return nullptr;
          char* p = f.line();
          int64_t tag = strtoll(p, &p, 10);
          node(p, tag);
        }
      } else {
        // numEntityBlocks numNodes minNodeTag maxNodeTag
        if (parse_ints(f.line(), v, 4) < 4) return nullptr;
        for (int64_t b = 0, nblocks = v[0]; b < nblocks; ++b) {
          // entityDim entityTag parametric numNodesInBlock
          if (!f.next() || parse_ints(f.line(), v, 4) < 4) return nullptr;
          int64_t nb = v[3];
          std::vector<int64_t> btags(nb);
          for (int64_t i = 0; i < nb; ++i) {
            if (!f.next() || parse_ints(f.line(), v, 1) < 1) return nullptr;
            btags[i] = v[0];
          }
          for (int64_t i = 0; i < nb; ++i) {
            if (!f.next()) return nullptr;
            node(f.line(), btags[i]);
          }
        }
      }
    } else if (f.starts("$Elements")) {
      int64_t maxtag = -1;
      for (auto t : tags) maxtag = std::max(maxtag, t);
      tag2idx.assign(maxtag + 1, -1);
      for (size_t i = 0; i < tags.size(); ++i)
        if (tags[i] >= 0) tag2idx[tags[i]] = (int64_t)i;
      if (!f.next()) return nullptr;
      if (version < 4.0) {
        if (parse_ints(f.line(), v, 1) < 1) return nullptr;
        for (int64_t i = 0, n = v[0]; i < n; ++i) {
          // tag type ntags tag... nodes...
          if (!f.next()) return nullptr;
          int got = parse_ints(f.line(), v, 64);
          if (got < 3) return nullptr;
          if (v[1] != 11) continue;
          int64_t first = 3 + v[2];
          if (v[2] < 0 || got < first + 10 || !element(v + first)) return nullptr;
        }
      } else {
        // numEntityBlocks numElements minElementTag maxElementTag
        if (parse_ints(f.line(), v, 4) < 4) return nullptr;
        for (int64_t b = 0, nblocks = v[0]; b < nblocks; ++b) {
          // entityDim entityTag elementType numElementsInBlock
          if (!f.next() || parse_ints(f.line(), v, 4) < 4) return nullptr;
          int64_t type = v[2], nb = v[3];
          for (int64_t i = 0; i < nb; ++i) {
            if (!f.next()) return nullptr;
            if (type != 11) continue;
            if (parse_ints(f.line(), v, 11) < 11 || !element(v + 1)) return nullptr;
          }
        }
      }
    }
  }
  m.nn = (int64_t)tags.size();
  m.coords = std::move(xyz);
  if (m.nn == 0 || m.ne == 0) return nullptr;
  return wrap(std::move(m));
}

// ---------------------------------------------------------------------------
// UNV (SMESH / FreeCAD FemMesh export): datasets 2411 (nodes), 2412 (elements)
// ---------------------------------------------------------------------------

FcvmMesh* fcvm_read_unv(const char* path) {
  // C stdio, not iostreams: the iostream version of this reader crashed
  // (SIGSEGV) on a 167,533-node file inside a process that had loaded
  // PyTorch and the port's CUDA extension on an H100 machine, though not in
  // a fresh process there; this one reads the file in both.
  LineReader f(path);
  if (!f.ok()) return nullptr;
  MeshData m;
  std::vector<int64_t> tags;
  std::vector<double> xyz;
  int64_t v[16];

  while (f.next()) {
    // datasets start and end with a line containing "-1"
    if (!f.starts("-1")) continue;
    if (!f.next()) break;
    int ds = atoi(f.line());
    if (ds == 2411) {
      while (f.next()) {
        if (f.starts("-1")) break;
        int64_t tag = parse_ints(f.line(), v, 1) == 1 ? v[0] : 0;
        if (!f.next()) break;
        // UNV uses Fortran D exponents
        for (char* c = f.line(); *c; ++c)
          if (*c == 'D' || *c == 'd') *c = 'E';
        char* p = f.line();
        double x = strtod(p, &p), y = strtod(p, &p), z = strtod(p, &p);
        tags.push_back(tag);
        xyz.push_back(x);
        xyz.push_back(y);
        xyz.push_back(z);
      }
    } else if (ds == 2412) {
      int64_t maxtag = 0;
      for (auto tg : tags) maxtag = std::max(maxtag, tg);
      std::vector<int64_t> tag2idx(maxtag + 1, -1);
      for (size_t i = 0; i < tags.size(); ++i)
        if (tags[i] >= 0) tag2idx[tags[i]] = (int64_t)i;
      while (f.next()) {
        if (f.starts("-1")) break;
        // tag, FE descriptor, physical and material property, colour, nodes
        if (parse_ints(f.line(), v, 6) < 6) continue;
        int64_t fe = v[1], nnodes = v[5];
        // Beam-family elements (UNV FE 11/21/22/23/24) carry one extra
        // orientation record between the header and the node list; SMESH /
        // FreeCAD meshes include them for edge groups.
        if (fe == 11 || fe == 21 || fe == 22 || fe == 23 || fe == 24) {
          if (!f.next()) break;
        }
        std::vector<int64_t> nd;
        while ((int64_t)nd.size() < nnodes && f.next()) {
          int n = parse_ints(f.line(), v, 16);
          nd.insert(nd.end(), v, v + n);
        }
        if (fe == 118 && nnodes == 10) {
          if (nd.size() < 10) return nullptr;
          int64_t row[10];
          for (int k = 0; k < 10; ++k) {
            if (nd[k] < 0 || nd[k] > maxtag || tag2idx[nd[k]] < 0) return nullptr;
            row[kUnvToFcvm[k]] = tag2idx[nd[k]];
          }
          for (int k = 0; k < 10; ++k) m.elnodes.push_back(row[k]);
          ++m.ne;
        }
      }
    } else {
      // skip to dataset end
      while (f.next())
        if (f.starts("-1")) break;
    }
  }
  m.nn = (int64_t)tags.size();
  m.coords = std::move(xyz);
  if (m.nn == 0 || m.ne == 0) return nullptr;
  return wrap(std::move(m));
}

// ---------------------------------------------------------------------------
// Graph preprocessing
// ---------------------------------------------------------------------------

// Node adjacency (corner+midside coupling through shared elements), CSR.
static void build_adjacency(int64_t nn, int64_t ne, const int64_t* elnodes,
                            std::vector<int64_t>& ptr,
                            std::vector<int64_t>& adj) {
  std::vector<std::vector<int64_t>> nbr(nn);
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t* nd = elnodes + 10 * e;
    for (int i = 0; i < 10; ++i)
      for (int j = 0; j < 10; ++j)
        if (i != j) nbr[nd[i]].push_back(nd[j]);
  }
  ptr.assign(nn + 1, 0);
  for (int64_t n = 0; n < nn; ++n) {
    auto& v = nbr[n];
    std::sort(v.begin(), v.end());
    v.erase(std::unique(v.begin(), v.end()), v.end());
    ptr[n + 1] = ptr[n] + (int64_t)v.size();
  }
  adj.resize(ptr[nn]);
  for (int64_t n = 0; n < nn; ++n)
    std::copy(nbr[n].begin(), nbr[n].end(), adj.begin() + ptr[n]);
}

// Reverse Cuthill-McKee: perm_out[new_index] = old_index.
int fcvm_rcm_order(int64_t nn, int64_t ne, const int64_t* elnodes,
                   int64_t* perm_out) {
  std::vector<int64_t> ptr, adj;
  build_adjacency(nn, ne, elnodes, ptr, adj);
  std::vector<int64_t> degree(nn);
  for (int64_t n = 0; n < nn; ++n) degree[n] = ptr[n + 1] - ptr[n];

  std::vector<char> visited(nn, 0);
  std::vector<int64_t> order;
  order.reserve(nn);
  for (;;) {
    // unvisited node of minimum degree as the next component's seed
    int64_t seed = -1;
    for (int64_t n = 0; n < nn; ++n)
      if (!visited[n] && (seed < 0 || degree[n] < degree[seed])) seed = n;
    if (seed < 0) break;
    std::queue<int64_t> q;
    q.push(seed);
    visited[seed] = 1;
    while (!q.empty()) {
      int64_t n = q.front();
      q.pop();
      order.push_back(n);
      std::vector<int64_t> next;
      for (int64_t k = ptr[n]; k < ptr[n + 1]; ++k)
        if (!visited[adj[k]]) {
          visited[adj[k]] = 1;
          next.push_back(adj[k]);
        }
      std::sort(next.begin(), next.end(), [&](int64_t a, int64_t b) {
        return degree[a] < degree[b];
      });
      for (auto v : next) q.push(v);
    }
  }
  std::reverse(order.begin(), order.end());
  std::copy(order.begin(), order.end(), perm_out);
  return 0;
}

// Elements adjacent to each node (the reference's `noce`, fcVM.py:183-185).
int fcvm_node_element_counts(int64_t nn, int64_t ne, const int64_t* elnodes,
                             int64_t* counts_out) {
  std::fill(counts_out, counts_out + nn, 0);
  for (int64_t i = 0; i < ne * 10; ++i) ++counts_out[elnodes[i]];
  return 0;
}

// Fast text formatting for the legacy-VTK writer (runtime/vtk.py): %.10g
// per value, `per_line` values per line.  Python-side float formatting of
// multi-hundred-MB exports costs seconds per analysis; this is the
// native-runtime IO path (caller frees with fcvm_free_str).
char* fcvm_format_doubles(const double* v, int64_t n, int per_line,
                          int64_t* len_out) {
  size_t cap = (size_t)n * 20 + 16;
  char* buf = (char*)std::malloc(cap);
  if (!buf) return nullptr;
  size_t pos = 0;
  for (int64_t i = 0; i < n; ++i) {
    if (cap - pos < 32) {
      cap = cap * 2;
      char* nb = (char*)std::realloc(buf, cap);
      if (!nb) { std::free(buf); return nullptr; }
      buf = nb;
    }
    // std::to_chars: same text as printf %.10g, ~5x faster than snprintf
    auto res = std::to_chars(buf + pos, buf + cap - 2, v[i],
                             std::chars_format::general, 10);
    pos = (size_t)(res.ptr - buf);
    buf[pos++] = ((i + 1) % per_line == 0 || i + 1 == n) ? '\n' : ' ';
  }
  if (pos) --pos;  // strip the final newline (joined by caller)
  buf[pos] = 0;
  if (len_out) *len_out = (int64_t)pos;
  return buf;
}

// tet10 VTK cell lines: "10 n0 n1 ... n9" per element.
char* fcvm_format_cells(const int64_t* eln, int64_t ne, int64_t* len_out) {
  size_t cap = (size_t)ne * 11 * 13 + 16;
  char* buf = (char*)std::malloc(cap);
  if (!buf) return nullptr;
  size_t pos = 0;
  for (int64_t e = 0; e < ne; ++e) {
    pos += std::snprintf(buf + pos, cap - pos, "10");
    for (int k = 0; k < 10; ++k)
      pos += std::snprintf(buf + pos, cap - pos, " %lld",
                           (long long)eln[10 * e + k]);
    buf[pos++] = '\n';
  }
  if (pos) --pos;
  buf[pos] = 0;
  if (len_out) *len_out = (int64_t)pos;
  return buf;
}

void fcvm_free_str(char* s) { std::free(s); }

// Graph bandwidth (max |i-j| over coupled node pairs) — RCM quality metric.
int64_t fcvm_bandwidth(int64_t nn, int64_t ne, const int64_t* elnodes) {
  int64_t bw = 0;
  for (int64_t e = 0; e < ne; ++e) {
    const int64_t* nd = elnodes + 10 * e;
    for (int i = 0; i < 10; ++i)
      for (int j = i + 1; j < 10; ++j)
        bw = std::max(bw, std::abs(nd[i] - nd[j]));
  }
  return bw;
}

}  // extern "C"
