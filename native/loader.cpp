// Native scene loader: fast OBJ/MTL tokenizer exposed through a C ABI.
//
// The reference vendors tiny_obj_loader.h (3.5k LoC, C++) for ingestion
// (Myobj.cpp:10-28). This is the framework's native equivalent: a
// single-pass parser for the cg23 subset (v/vn/f/usemtl/mtllib + newmtl/
// Kd/Ks/Ns) that fills caller-allocated flat arrays, bound from Python via
// ctypes (scene/native_loader.py). The pure-Python parser in
// scene/objparse.py remains the always-available fallback and oracle.
//
// Two-phase protocol (no allocation handoff across the ABI):
//   1. h = mcpt_obj_open(path)        -> parse into internal buffers
//   2. mcpt_obj_counts(h, ...)        -> sizes
//   3. mcpt_obj_fill(h, ...)          -> memcpy into numpy-owned arrays
//   4. mcpt_obj_material(h, i, ...)   -> per-material record
//   5. mcpt_obj_close(h)

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Material {
  std::string name;
  float kd[3] = {0.f, 0.f, 0.f};
  float ks[3] = {0.f, 0.f, 0.f};
  float ns = 1.f;
  bool present = false;  // defined in a .mtl (vs merely referenced)
};

struct ObjData {
  std::vector<float> vertices;   // 3*V
  std::vector<float> normals;    // 3*VN
  std::vector<int32_t> face_v;   // 3*T
  std::vector<int32_t> face_vn;  // 3*T
  std::vector<int32_t> face_mat; // T
  std::vector<Material> materials;            // ordered by first use
  std::unordered_map<std::string, int> mat_index;
  std::string error;
};

// --- minimal fast tokenizer -------------------------------------------------

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* next_line(const char* p, const char* end) {
  while (p < end && *p != '\n') ++p;
  return p < end ? p + 1 : end;
}

inline const char* parse_float(const char* p, const char* end, float* out) {
  char* q = nullptr;
  *out = strtof(p, &q);
  return (q && q <= end) ? q : p;
}

inline const char* parse_int(const char* p, const char* end, long* out) {
  char* q = nullptr;
  *out = strtol(p, &q, 10);
  return (q && q <= end) ? q : p;
}

bool read_file(const std::string& path, std::string* out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize(n);
  size_t got = fread(out->empty() ? nullptr : &(*out)[0], 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

void parse_mtl(const std::string& path, ObjData* d) {
  std::string buf;
  if (!read_file(path, &buf)) return;  // missing mtl is non-fatal
  const char* p = buf.data();
  const char* end = p + buf.size();
  Material* cur = nullptr;
  std::unordered_map<std::string, size_t> local;
  std::vector<Material> defs;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (strncmp(p, "newmtl", 6) == 0 && (p + 6 >= end || isspace(p[6]))) {
      p = skip_ws(p + 6, end);
      const char* q = p;
      while (q < end && !isspace(static_cast<unsigned char>(*q))) ++q;
      defs.emplace_back();
      cur = &defs.back();
      cur->name.assign(p, q - p);
      cur->present = true;
      local[cur->name] = defs.size() - 1;
    } else if (cur && strncmp(p, "Kd", 2) == 0 && isspace(p[2])) {
      p += 2;
      for (float& x : cur->kd) p = parse_float(skip_ws(p, end), end, &x);
    } else if (cur && strncmp(p, "Ks", 2) == 0 && isspace(p[2])) {
      p += 2;
      for (float& x : cur->ks) p = parse_float(skip_ws(p, end), end, &x);
    } else if (cur && strncmp(p, "Ns", 2) == 0 && isspace(p[2])) {
      p += 2;
      p = parse_float(skip_ws(p, end), end, &cur->ns);
    }
    p = next_line(p, end);
  }
  // merge: definitions update (or append to) the referenced-material table
  for (auto& m : defs) {
    auto it = d->mat_index.find(m.name);
    if (it == d->mat_index.end()) {
      d->mat_index[m.name] = static_cast<int>(d->materials.size());
      d->materials.push_back(m);
    } else {
      d->materials[it->second] = m;
    }
  }
}

int mat_id(ObjData* d, const std::string& name) {
  auto it = d->mat_index.find(name);
  if (it != d->mat_index.end()) return it->second;
  int id = static_cast<int>(d->materials.size());
  Material m;
  m.name = name;
  d->materials.push_back(m);
  d->mat_index[name] = id;
  return id;
}

std::string dirname_of(const std::string& path) {
  size_t k = path.find_last_of("/\\");
  return k == std::string::npos ? std::string() : path.substr(0, k + 1);
}

}  // namespace

extern "C" {

void* mcpt_obj_open(const char* path) {
  auto* d = new ObjData();
  std::string buf;
  if (!read_file(path, &buf)) {
    d->error = "cannot read obj file";
    return d;
  }
  const char* p = buf.data();
  const char* end = p + buf.size();
  int cur_mat = -1;
  std::vector<long> vs, vns;  // per-face scratch
  const std::string dir = dirname_of(path);

  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (p[0] == 'v' && p + 1 < end && isspace(static_cast<unsigned char>(p[1]))) {
      float x[3];
      const char* q = p + 1;
      for (float& c : x) q = parse_float(skip_ws(q, end), end, &c);
      d->vertices.insert(d->vertices.end(), x, x + 3);
    } else if (p[0] == 'v' && p + 1 < end && p[1] == 'n' &&
               (p + 2 >= end || isspace(static_cast<unsigned char>(p[2])))) {
      float x[3];
      const char* q = p + 2;
      for (float& c : x) q = parse_float(skip_ws(q, end), end, &c);
      d->normals.insert(d->normals.end(), x, x + 3);
    } else if (p[0] == 'f' && p + 1 < end && isspace(static_cast<unsigned char>(p[1]))) {
      vs.clear();
      vns.clear();
      const char* q = p + 1;
      const char* line_end = q;
      while (line_end < end && *line_end != '\n') ++line_end;
      while (true) {
        q = skip_ws(q, line_end);
        if (q >= line_end) break;
        long v = 0, vn = 0;
        q = parse_int(q, line_end, &v);
        if (q < line_end && *q == '/') {
          ++q;
          if (q < line_end && *q != '/') {
            long vt;
            q = parse_int(q, line_end, &vt);  // texcoord index: ignored
          }
          if (q < line_end && *q == '/') {
            ++q;
            q = parse_int(q, line_end, &vn);
          }
        }
        long nv = static_cast<long>(d->vertices.size() / 3);
        long nn = static_cast<long>(d->normals.size() / 3);
        vs.push_back(v > 0 ? v - 1 : (v < 0 ? nv + v : -1));
        vns.push_back(vn > 0 ? vn - 1 : (vn < 0 ? nn + vn : -1));
        // advance past any trailing garbage in the chunk
        while (q < line_end && !isspace(static_cast<unsigned char>(*q))) ++q;
      }
      for (size_t k = 1; k + 1 < vs.size(); ++k) {  // fan triangulation
        const long fv[3] = {vs[0], vs[k], vs[k + 1]};
        const long fn[3] = {vns[0], vns[k], vns[k + 1]};
        for (long i : fv) d->face_v.push_back(static_cast<int32_t>(i));
        for (long i : fn) d->face_vn.push_back(static_cast<int32_t>(i));
        d->face_mat.push_back(cur_mat);
      }
    } else if (strncmp(p, "usemtl", 6) == 0) {
      const char* q = skip_ws(p + 6, end);
      const char* e = q;
      while (e < end && *e != '\n' && *e != '\r') ++e;
      while (e > q && isspace(static_cast<unsigned char>(e[-1]))) --e;
      cur_mat = mat_id(d, std::string(q, e - q));
    } else if (strncmp(p, "mtllib", 6) == 0) {
      const char* q = skip_ws(p + 6, end);
      const char* e = q;
      while (e < end && *e != '\n' && *e != '\r') ++e;
      while (e > q && isspace(static_cast<unsigned char>(e[-1]))) --e;
      parse_mtl(dir + std::string(q, e - q), d);
    }
    p = next_line(p, end);
  }
  return d;
}

const char* mcpt_obj_error(void* h) {
  auto* d = static_cast<ObjData*>(h);
  return d->error.empty() ? nullptr : d->error.c_str();
}

void mcpt_obj_counts(void* h, int64_t* nv, int64_t* nn, int64_t* nt,
                     int64_t* nmat) {
  auto* d = static_cast<ObjData*>(h);
  *nv = d->vertices.size() / 3;
  *nn = d->normals.size() / 3;
  *nt = d->face_v.size() / 3;
  *nmat = d->materials.size();
}

void mcpt_obj_fill(void* h, float* v, float* vn, int32_t* fv, int32_t* fvn,
                   int32_t* fmat) {
  auto* d = static_cast<ObjData*>(h);
  memcpy(v, d->vertices.data(), d->vertices.size() * sizeof(float));
  memcpy(vn, d->normals.data(), d->normals.size() * sizeof(float));
  memcpy(fv, d->face_v.data(), d->face_v.size() * sizeof(int32_t));
  memcpy(fvn, d->face_vn.data(), d->face_vn.size() * sizeof(int32_t));
  memcpy(fmat, d->face_mat.data(), d->face_mat.size() * sizeof(int32_t));
}

// name_buf must hold >= 256 bytes. Returns 1 if the material had a .mtl
// definition, 0 if it was only referenced.
int mcpt_obj_material(void* h, int64_t i, char* name_buf, float* kd,
                      float* ks, float* ns) {
  auto* d = static_cast<ObjData*>(h);
  const Material& m = d->materials[i];
  snprintf(name_buf, 256, "%s", m.name.c_str());
  memcpy(kd, m.kd, sizeof(m.kd));
  memcpy(ks, m.ks, sizeof(m.ks));
  *ns = m.ns;
  return m.present ? 1 : 0;
}

void mcpt_obj_close(void* h) { delete static_cast<ObjData*>(h); }

}  // extern "C"
