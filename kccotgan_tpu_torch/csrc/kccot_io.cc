// kccot_io: native TFRecord reader and tf.train.{Example,SequenceExample}
// wire-format parser for the data pipeline of kccotgan_tpu_torch.
//
// The port's copy of the JAX package's native reader.  The pure-Python
// backend (`kccotgan_tpu_torch/data/tfrecord.py`) implements the same
// container and proto subset and is its semantics oracle; this library
// is its native twin: framing walks over an mmap outside the GIL,
// hardware CRC32C (SSE4.2, with a slicing-by-8 software fallback), and a
// single-pass proto parse into one handle per record, so that reading
// records keeps up with the card.
//
// Host code with a plain C ABI, loaded through ctypes
// (`data/native_io.py`).  Built by `_build.py::load_io_library` with the
// host C++ compiler (`$CXX`, else g++):
//   g++ -O3 -std=c++17 -fPIC -Wall -Wextra -fvisibility=hidden -shared
// A truncated record is an error (`kc_reader_error`), as in the Python
// backend, whatever `verify_crc` says.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#if defined(__x86_64__)
#include <cpuid.h>
#include <nmmintrin.h>
#endif

#define KC_API extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------- crc32c

uint32_t g_crc_table[8][256];

void fill_crc_tables() {
  const uint32_t poly = 0x82F63B78u;  // Castagnoli, reflected
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? (c >> 1) ^ poly : c >> 1;
    g_crc_table[0][n] = c;
  }
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = g_crc_table[0][n];
    for (int t = 1; t < 8; ++t) {
      c = g_crc_table[0][c & 0xFF] ^ (c >> 8);
      g_crc_table[t][n] = c;
    }
  }
}

// Readers may run in several threads: a function-local static is
// initialised once, and the others wait for it.
void crc_init_tables() {
  static const bool filled = (fill_crc_tables(), true);
  (void)filled;
}

uint32_t crc32c_sw(uint32_t crc, const uint8_t* p, size_t n) {
  crc_init_tables();
  // slicing-by-8
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    w ^= crc;
    crc = g_crc_table[7][w & 0xFF] ^ g_crc_table[6][(w >> 8) & 0xFF] ^
          g_crc_table[5][(w >> 16) & 0xFF] ^ g_crc_table[4][(w >> 24) & 0xFF] ^
          g_crc_table[3][(w >> 32) & 0xFF] ^ g_crc_table[2][(w >> 40) & 0xFF] ^
          g_crc_table[1][(w >> 48) & 0xFF] ^ g_crc_table[0][(w >> 56) & 0xFF];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_crc_table[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return crc;
}

#if defined(__x86_64__)
__attribute__((target("sse4.2")))
uint32_t crc32c_hw(uint32_t crc, const uint8_t* p, size_t n) {
  uint64_t c = crc;
  while (n >= 8) {
    uint64_t w;
    memcpy(&w, p, 8);
    c = _mm_crc32_u64(c, w);
    p += 8;
    n -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (n--) c32 = _mm_crc32_u8(c32, *p++);
  return c32;
}

bool have_sse42() {
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return (ecx & (1u << 20)) != 0;
}
#endif

uint32_t crc32c(const uint8_t* p, size_t n) {
#if defined(__x86_64__)
  static const bool hw = have_sse42();
  if (hw) return ~crc32c_hw(0xFFFFFFFFu, p, n);
#endif
  return ~crc32c_sw(0xFFFFFFFFu, p, n);
}

uint32_t masked_crc32c(const uint8_t* p, size_t n) {
  uint32_t c = crc32c(p, n);
  return ((c >> 15) | (c << 17)) + 0xA282EAD8u;
}

// --------------------------------------------------------------- framing

struct Record {
  uint64_t off;
  uint64_t len;
};

struct KcReaderImpl {
  int fd = -1;
  const uint8_t* map = nullptr;
  uint64_t size = 0;
  std::vector<Record> index;
  std::string error;
};

// --------------------------------------------------------- proto parsing
//
// Field tree (tensorflow/core/example/{example,feature}.proto):
//   Example         { Features features = 1 }
//   SequenceExample { Features context = 1; FeatureLists feature_lists = 2 }
//   Features        { map<string, Feature> feature = 1 }   (MapEntry k=1 v=2)
//   FeatureLists    { map<string, FeatureList> feature_list = 1 }
//   FeatureList     { repeated Feature feature = 1 }
//   Feature         { BytesList=1 | FloatList=2 | Int64List=3 }  (value = 1)

struct View {
  const uint8_t* p;
  uint64_t n;
};

struct FeatureVal {
  int kind = 0;  // 0 none, 1 bytes, 2 floats, 3 ints
  std::vector<View> bytes;  // views into KcParsedImpl::owned
  std::vector<float> floats;
  std::vector<int64_t> ints;
};

struct KcParsedImpl {
  std::vector<uint8_t> owned;  // record copy; all Views point here
  std::vector<std::pair<std::string, FeatureVal>> feats;
  std::vector<std::pair<std::string, std::vector<FeatureVal>>> flists;
  std::unordered_map<std::string, size_t> fidx;
  std::unordered_map<std::string, size_t> flidx;
};

bool read_varint(const uint8_t* buf, uint64_t len, uint64_t* pos, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (*pos < len && shift < 64) {
    uint8_t b = buf[(*pos)++];
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

struct Field {
  uint32_t number;
  uint32_t wire;
  View val;       // wire 2: delimited bytes; wire 1/5: fixed bytes
  uint64_t ival;  // wire 0
};

// Iterate fields of a message region; returns false on malformed input.
template <typename Fn>
bool for_each_field(View msg, Fn fn) {
  uint64_t pos = 0;
  while (pos < msg.n) {
    uint64_t tag;
    if (!read_varint(msg.p, msg.n, &pos, &tag)) return false;
    Field f;
    f.number = static_cast<uint32_t>(tag >> 3);
    f.wire = static_cast<uint32_t>(tag & 7);
    switch (f.wire) {
      case 0:
        if (!read_varint(msg.p, msg.n, &pos, &f.ival)) return false;
        break;
      case 2: {
        uint64_t l;
        if (!read_varint(msg.p, msg.n, &pos, &l)) return false;
        if (pos + l > msg.n) return false;
        f.val = {msg.p + pos, l};
        pos += l;
        break;
      }
      case 5:
        if (pos + 4 > msg.n) return false;
        f.val = {msg.p + pos, 4};
        pos += 4;
        break;
      case 1:
        if (pos + 8 > msg.n) return false;
        f.val = {msg.p + pos, 8};
        pos += 8;
        break;
      default:
        return false;
    }
    if (!fn(f)) return false;
  }
  return true;
}

bool parse_feature(View buf, FeatureVal* out) {
  return for_each_field(buf, [&](const Field& f) {
    if (f.wire != 2) return true;
    if (f.number == 1) {  // BytesList { repeated bytes value = 1 }
      out->kind = 1;
      return for_each_field(f.val, [&](const Field& v) {
        if (v.number == 1 && v.wire == 2) out->bytes.push_back(v.val);
        return true;
      });
    }
    if (f.number == 2) {  // FloatList { repeated float value = 1 [packed] }
      out->kind = 2;
      return for_each_field(f.val, [&](const Field& v) {
        if (v.number != 1) return true;
        if (v.wire == 2) {  // packed
          uint64_t cnt = v.val.n / 4;
          size_t base = out->floats.size();
          out->floats.resize(base + cnt);
          memcpy(out->floats.data() + base, v.val.p, cnt * 4);
        } else if (v.wire == 5) {
          float x;
          memcpy(&x, v.val.p, 4);
          out->floats.push_back(x);
        }
        return true;
      });
    }
    if (f.number == 3) {  // Int64List { repeated int64 value = 1 [packed] }
      out->kind = 3;
      return for_each_field(f.val, [&](const Field& v) {
        if (v.number != 1) return true;
        if (v.wire == 2) {  // packed varints
          uint64_t pos = 0, x;
          while (pos < v.val.n) {
            if (!read_varint(v.val.p, v.val.n, &pos, &x)) return false;
            out->ints.push_back(static_cast<int64_t>(x));
          }
        } else if (v.wire == 0) {
          out->ints.push_back(static_cast<int64_t>(v.ival));
        }
        return true;
      });
    }
    return true;
  });
}

bool parse_features_map(View buf, std::vector<std::pair<std::string, FeatureVal>>* out) {
  return for_each_field(buf, [&](const Field& f) {
    if (f.number != 1 || f.wire != 2) return true;
    std::string key;
    FeatureVal val;
    bool ok = for_each_field(f.val, [&](const Field& e) {
      if (e.wire != 2) return true;
      if (e.number == 1) key.assign(reinterpret_cast<const char*>(e.val.p), e.val.n);
      if (e.number == 2) return parse_feature(e.val, &val);
      return true;
    });
    if (!ok) return false;
    out->emplace_back(std::move(key), std::move(val));
    return true;
  });
}

bool parse_feature_lists(View buf, std::vector<std::pair<std::string, std::vector<FeatureVal>>>* out) {
  return for_each_field(buf, [&](const Field& f) {
    if (f.number != 1 || f.wire != 2) return true;  // map entry
    std::string key;
    std::vector<FeatureVal> steps;
    bool ok = for_each_field(f.val, [&](const Field& e) {
      if (e.wire != 2) return true;
      if (e.number == 1) key.assign(reinterpret_cast<const char*>(e.val.p), e.val.n);
      if (e.number == 2) {  // FeatureList
        return for_each_field(e.val, [&](const Field& s) {
          if (s.number != 1 || s.wire != 2) return true;
          FeatureVal v;
          if (!parse_feature(s.val, &v)) return false;
          steps.push_back(std::move(v));
          return true;
        });
      }
      return true;
    });
    if (!ok) return false;
    out->emplace_back(std::move(key), std::move(steps));
    return true;
  });
}

}  // namespace

// ================================================================ C ABI

KC_API uint32_t kc_masked_crc32c(const uint8_t* data, int64_t len) {
  return masked_crc32c(data, static_cast<size_t>(len));
}

KC_API void* kc_reader_open(const char* path, int verify_crc) {
  auto* r = new KcReaderImpl();
  r->fd = open(path, O_RDONLY);
  if (r->fd < 0) {
    delete r;
    return nullptr;
  }
  struct stat st;
  if (fstat(r->fd, &st) != 0) {
    close(r->fd);
    delete r;
    return nullptr;
  }
  r->size = static_cast<uint64_t>(st.st_size);
  if (r->size > 0) {
    void* m = mmap(nullptr, r->size, PROT_READ, MAP_PRIVATE, r->fd, 0);
    if (m == MAP_FAILED) {
      close(r->fd);
      delete r;
      return nullptr;
    }
    r->map = static_cast<const uint8_t*>(m);
    madvise(const_cast<uint8_t*>(r->map), r->size, MADV_SEQUENTIAL);
  }
  // index: [u64 len][u32 crc(len)][payload][u32 crc(payload)]
  uint64_t pos = 0;
  while (pos + 12 <= r->size) {
    uint64_t len;
    memcpy(&len, r->map + pos, 8);  // little-endian host assumed (x86/arm)
    if (verify_crc) {
      uint32_t want;
      memcpy(&want, r->map + pos + 8, 4);
      if (masked_crc32c(r->map + pos, 8) != want) {
        r->error = "corrupt length crc";
        break;
      }
    }
    uint64_t data_off = pos + 12;
    if (len > r->size - data_off) {
      r->error = "truncated record";
      break;
    }
    if (r->size - data_off - len < 4) {  // the payload's crc cut off
      if (verify_crc) {
        r->error = "truncated record";
      } else {
        r->index.push_back({data_off, len});
      }
      break;
    }
    if (verify_crc) {
      uint32_t want;
      memcpy(&want, r->map + data_off + len, 4);
      if (masked_crc32c(r->map + data_off, len) != want) {
        r->error = "corrupt data crc";
        break;
      }
    }
    r->index.push_back({data_off, len});
    pos = data_off + len + 4;
  }
  return r;
}

KC_API void kc_reader_close(void* h) {
  auto* r = static_cast<KcReaderImpl*>(h);
  if (!r) return;
  if (r->map) munmap(const_cast<uint8_t*>(r->map), r->size);
  if (r->fd >= 0) close(r->fd);
  delete r;
}

KC_API int64_t kc_reader_count(void* h) {
  return static_cast<KcReaderImpl*>(h)->index.size();
}

KC_API int64_t kc_reader_record_len(void* h, int64_t i) {
  auto* r = static_cast<KcReaderImpl*>(h);
  if (i < 0 || i >= static_cast<int64_t>(r->index.size())) return -1;
  return static_cast<int64_t>(r->index[i].len);
}

KC_API const uint8_t* kc_reader_record(void* h, int64_t i) {
  auto* r = static_cast<KcReaderImpl*>(h);
  if (i < 0 || i >= static_cast<int64_t>(r->index.size())) return nullptr;
  return r->map + r->index[i].off;
}

KC_API const char* kc_reader_error(void* h) {
  auto* r = static_cast<KcReaderImpl*>(h);
  return r->error.empty() ? nullptr : r->error.c_str();
}

// ----- parsed Example / SequenceExample handle

KC_API void* kc_parse(const uint8_t* buf, int64_t len) {
  auto* p = new KcParsedImpl();
  p->owned.assign(buf, buf + len);
  View rec{p->owned.data(), static_cast<uint64_t>(len)};
  bool ok = for_each_field(rec, [&](const Field& f) {
    if (f.wire != 2) return true;
    if (f.number == 1) return parse_features_map(f.val, &p->feats);
    if (f.number == 2) return parse_feature_lists(f.val, &p->flists);
    return true;
  });
  if (!ok) {
    delete p;
    return nullptr;
  }
  for (size_t i = 0; i < p->feats.size(); ++i) p->fidx[p->feats[i].first] = i;
  for (size_t i = 0; i < p->flists.size(); ++i) p->flidx[p->flists[i].first] = i;
  return p;
}

KC_API void kc_parsed_free(void* h) { delete static_cast<KcParsedImpl*>(h); }

namespace {
const FeatureVal* find_feat(KcParsedImpl* p, const char* key) {
  auto it = p->fidx.find(key);
  return it == p->fidx.end() ? nullptr : &p->feats[it->second].second;
}
const std::vector<FeatureVal>* find_flist(KcParsedImpl* p, const char* key) {
  auto it = p->flidx.find(key);
  return it == p->flidx.end() ? nullptr : &p->flists[it->second].second;
}
const FeatureVal* flist_step(KcParsedImpl* p, const char* key, int64_t step) {
  auto* fl = find_flist(p, key);
  if (!fl || step < 0 || step >= static_cast<int64_t>(fl->size())) return nullptr;
  return &(*fl)[step];
}
}  // namespace

// context / Example features --------------------------------------------

KC_API int64_t kc_num_features(void* h) {
  return static_cast<KcParsedImpl*>(h)->feats.size();
}

KC_API const char* kc_feature_key(void* h, int64_t i) {
  auto* p = static_cast<KcParsedImpl*>(h);
  if (i < 0 || i >= static_cast<int64_t>(p->feats.size())) return nullptr;
  return p->feats[i].first.c_str();
}

KC_API int kc_feature_kind(void* h, const char* key) {
  auto* f = find_feat(static_cast<KcParsedImpl*>(h), key);
  return f ? f->kind : 0;
}

KC_API int64_t kc_feature_len(void* h, const char* key) {
  auto* f = find_feat(static_cast<KcParsedImpl*>(h), key);
  if (!f) return -1;
  if (f->kind == 1) return f->bytes.size();
  if (f->kind == 2) return f->floats.size();
  if (f->kind == 3) return f->ints.size();
  return 0;
}

KC_API const float* kc_feature_floats(void* h, const char* key) {
  auto* f = find_feat(static_cast<KcParsedImpl*>(h), key);
  return (f && f->kind == 2) ? f->floats.data() : nullptr;
}

KC_API const int64_t* kc_feature_ints(void* h, const char* key) {
  auto* f = find_feat(static_cast<KcParsedImpl*>(h), key);
  return (f && f->kind == 3) ? f->ints.data() : nullptr;
}

KC_API int64_t kc_feature_bytes_size(void* h, const char* key, int64_t j) {
  auto* f = find_feat(static_cast<KcParsedImpl*>(h), key);
  if (!f || f->kind != 1 || j < 0 || j >= static_cast<int64_t>(f->bytes.size()))
    return -1;
  return static_cast<int64_t>(f->bytes[j].n);
}

KC_API const uint8_t* kc_feature_bytes_data(void* h, const char* key, int64_t j) {
  auto* f = find_feat(static_cast<KcParsedImpl*>(h), key);
  if (!f || f->kind != 1 || j < 0 || j >= static_cast<int64_t>(f->bytes.size()))
    return nullptr;
  return f->bytes[j].p;
}

// feature_lists (SequenceExample) ----------------------------------------

KC_API int64_t kc_num_feature_lists(void* h) {
  return static_cast<KcParsedImpl*>(h)->flists.size();
}

KC_API const char* kc_feature_list_key(void* h, int64_t i) {
  auto* p = static_cast<KcParsedImpl*>(h);
  if (i < 0 || i >= static_cast<int64_t>(p->flists.size())) return nullptr;
  return p->flists[i].first.c_str();
}

KC_API int64_t kc_feature_list_steps(void* h, const char* key) {
  auto* fl = find_flist(static_cast<KcParsedImpl*>(h), key);
  return fl ? static_cast<int64_t>(fl->size()) : -1;
}

KC_API int kc_flist_kind(void* h, const char* key, int64_t step) {
  auto* f = flist_step(static_cast<KcParsedImpl*>(h), key, step);
  return f ? f->kind : 0;
}

KC_API int64_t kc_flist_len(void* h, const char* key, int64_t step) {
  auto* f = flist_step(static_cast<KcParsedImpl*>(h), key, step);
  if (!f) return -1;
  if (f->kind == 1) return f->bytes.size();
  if (f->kind == 2) return f->floats.size();
  if (f->kind == 3) return f->ints.size();
  return 0;
}

KC_API const float* kc_flist_floats(void* h, const char* key, int64_t step) {
  auto* f = flist_step(static_cast<KcParsedImpl*>(h), key, step);
  return (f && f->kind == 2) ? f->floats.data() : nullptr;
}

KC_API const int64_t* kc_flist_ints(void* h, const char* key, int64_t step) {
  auto* f = flist_step(static_cast<KcParsedImpl*>(h), key, step);
  return (f && f->kind == 3) ? f->ints.data() : nullptr;
}

KC_API int64_t kc_flist_bytes_size(void* h, const char* key, int64_t step, int64_t j) {
  auto* f = flist_step(static_cast<KcParsedImpl*>(h), key, step);
  if (!f || f->kind != 1 || j < 0 || j >= static_cast<int64_t>(f->bytes.size()))
    return -1;
  return static_cast<int64_t>(f->bytes[j].n);
}

KC_API const uint8_t* kc_flist_bytes_data(void* h, const char* key, int64_t step, int64_t j) {
  auto* f = flist_step(static_cast<KcParsedImpl*>(h), key, step);
  if (!f || f->kind != 1 || j < 0 || j >= static_cast<int64_t>(f->bytes.size()))
    return nullptr;
  return f->bytes[j].p;
}
