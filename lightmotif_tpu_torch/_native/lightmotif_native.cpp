/* Native host runtime for lightmotif_tpu_torch (the same source as the
 * JAX package's `lightmotif_tpu/_native/lightmotif_native.cpp`).
 *
 * The reference implements its data path in Rust with SIMD intrinsics
 * (`lightmotif/src/pli/platform/*.rs`); on the GPU the compute kernels
 * are CUDA, and this module provides the *host-side* native runtime the
 * device path feeds from: sequence encoding (ASCII -> rank), fused FASTA
 * parsing + encoding, and symbol counting.  All loops release the GIL.
 *
 * Exposed functions (CPython C API, no pybind11 dependency):
 *   encode(data: bytes, lut: bytes, lossy: bool, default: int) -> bytes
 *   parse_fasta(data: bytes, lut: bytes, default: int)
 *       -> list[(name: str, desc: str | None, encoded: bytes)]
 *   count_symbols(encoded: bytes, k: int) -> list[int]
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#define LM_X86 1
#include <immintrin.h>
#endif

namespace {

struct EncodeResult {
    long invalid_at = -1;  // first invalid byte position, or -1
};

#ifdef LM_X86
// The SIMD path handles LUTs whose valid entries all live in the ASCII
// range [0x40, 0x7F] (every alphabet here: letters only).  The analogue
// of the reference's cmpeq/blendv pipeline (avx2.rs:40-99), but table-
// driven: rank = table32[case][c & 0x1F] via two pshufb halves, with a
// (c & 0xC0) == 0x40 range check; everything else encodes as 0xFF.
static bool lut_simd_ok(const uint8_t* lut) {
    for (int c = 0; c < 256; ++c) {
        if (lut[c] != 0xFF && (c < 0x40 || c > 0x7F)) return false;
    }
    return true;
}

__attribute__((target("avx2"))) static Py_ssize_t encode_avx2(
    const uint8_t* src, Py_ssize_t n, const uint8_t* lut, bool lossy,
    uint8_t dflt, uint8_t* dst, bool* any_bad) {
    alignas(32) uint8_t t[4][32];
    for (int i = 0; i < 16; ++i) {
        t[0][i] = t[0][i + 16] = lut[0x40 + i];
        t[1][i] = t[1][i + 16] = lut[0x50 + i];
        t[2][i] = t[2][i + 16] = lut[0x60 + i];
        t[3][i] = t[3][i + 16] = lut[0x70 + i];
    }
    const __m256i U0 = _mm256_load_si256((const __m256i*)t[0]);
    const __m256i U1 = _mm256_load_si256((const __m256i*)t[1]);
    const __m256i L0 = _mm256_load_si256((const __m256i*)t[2]);
    const __m256i L1 = _mm256_load_si256((const __m256i*)t[3]);
    const __m256i nib = _mm256_set1_epi8(0x0F);
    const __m256i hi2 = _mm256_set1_epi8((char)0xC0);
    const __m256i at = _mm256_set1_epi8(0x40);
    const __m256i inval = _mm256_set1_epi8((char)0xFF);
    const __m256i vdflt = _mm256_set1_epi8((char)dflt);
    __m256i bad = _mm256_setzero_si256();
    Py_ssize_t i = 0;
    for (; i + 32 <= n; i += 32) {
        __m256i v = _mm256_loadu_si256((const __m256i*)(src + i));
        __m256i idx = _mm256_and_si256(v, nib);
        // bit4 -> bit7 / bit5 -> bit7 for blendv sign selection
        __m256i half = _mm256_slli_epi16(v, 3);
        __m256i lower = _mm256_slli_epi16(v, 2);
        __m256i rU = _mm256_blendv_epi8(_mm256_shuffle_epi8(U0, idx),
                                        _mm256_shuffle_epi8(U1, idx), half);
        __m256i rL = _mm256_blendv_epi8(_mm256_shuffle_epi8(L0, idx),
                                        _mm256_shuffle_epi8(L1, idx), half);
        __m256i r = _mm256_blendv_epi8(rU, rL, lower);
        __m256i ok = _mm256_cmpeq_epi8(_mm256_and_si256(v, hi2), at);
        r = _mm256_blendv_epi8(inval, r, ok);
        __m256i isbad = _mm256_cmpeq_epi8(r, inval);
        if (lossy) {
            r = _mm256_blendv_epi8(r, vdflt, isbad);
        } else {
            bad = _mm256_or_si256(bad, isbad);
        }
        _mm256_storeu_si256((__m256i*)(dst + i), r);
    }
    *any_bad = !_mm256_testz_si256(bad, bad);
    return i;
}
#endif  // LM_X86

// Table-lookup encode; SIMD fast path + scalar tail/fallback, one
// validity re-scan to recover the first invalid position.
static EncodeResult encode_into(const uint8_t* src, Py_ssize_t n,
                                const uint8_t* lut, bool lossy,
                                uint8_t dflt, uint8_t* dst) {
    EncodeResult res;
    Py_ssize_t start = 0;
    bool vec_bad = false;
#ifdef LM_X86
    if (n >= 64 && __builtin_cpu_supports("avx2") && lut_simd_ok(lut)) {
        start = encode_avx2(src, n, lut, lossy, dflt, dst, &vec_bad);
    }
#endif
    if (lossy) {
        for (Py_ssize_t i = start; i < n; ++i) {
            uint8_t v = lut[src[i]];
            dst[i] = (v == 0xFF) ? dflt : v;
        }
        return res;
    }
    uint8_t bad = 0;
    for (Py_ssize_t i = start; i < n; ++i) {
        uint8_t v = lut[src[i]];
        dst[i] = v;
        bad |= (uint8_t)(v == 0xFF);
    }
    if (bad || vec_bad) {
        for (Py_ssize_t i = 0; i < n; ++i) {
            if (dst[i] == 0xFF) {
                res.invalid_at = (long)i;
                break;
            }
        }
    }
    return res;
}

static PyObject* py_encode(PyObject*, PyObject* args) {
    Py_buffer data, lut;
    int lossy = 0;
    int dflt = 0;
    if (!PyArg_ParseTuple(args, "y*y*pi", &data, &lut, &lossy, &dflt)) {
        return nullptr;
    }
    if (lut.len < 256) {
        PyBuffer_Release(&data);
        PyBuffer_Release(&lut);
        PyErr_SetString(PyExc_ValueError, "lut must have 256 entries");
        return nullptr;
    }
    PyObject* out = PyBytes_FromStringAndSize(nullptr, data.len);
    if (!out) {
        PyBuffer_Release(&data);
        PyBuffer_Release(&lut);
        return nullptr;
    }
    EncodeResult res;
    Py_BEGIN_ALLOW_THREADS
    res = encode_into((const uint8_t*)data.buf, data.len,
                      (const uint8_t*)lut.buf, lossy != 0, (uint8_t)dflt,
                      (uint8_t*)PyBytes_AS_STRING(out));
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&data);
    PyBuffer_Release(&lut);
    if (res.invalid_at >= 0) {
        Py_DECREF(out);
        PyErr_Format(PyExc_ValueError, "invalid symbol at position %ld",
                     res.invalid_at);
        return nullptr;
    }
    return out;
}

struct FastaRecord {
    std::string name;
    std::string desc;
    std::string encoded;
    long invalid_at = -1;
};

static int parse_fasta_impl(const uint8_t* p, Py_ssize_t n,
                            const uint8_t* lut, uint8_t dflt,
                            std::vector<FastaRecord>& out) {
    Py_ssize_t i = 0;
    FastaRecord* cur = nullptr;
    while (i < n) {
        if (p[i] == '>') {
            // header line
            Py_ssize_t j = i + 1;
            while (j < n && p[j] != '\n') ++j;
            Py_ssize_t name_end = i + 1;
            while (name_end < j && p[name_end] != ' ' && p[name_end] != '\t')
                ++name_end;
            out.emplace_back();
            cur = &out.back();
            cur->name.assign((const char*)p + i + 1, name_end - i - 1);
            Py_ssize_t d = name_end;
            while (d < j && (p[d] == ' ' || p[d] == '\t')) ++d;
            Py_ssize_t de = j;
            while (de > d && (p[de - 1] == '\r' || p[de - 1] == ' ')) --de;
            if (de > d) cur->desc.assign((const char*)p + d, de - d);
            i = j + 1;
        } else if (cur == nullptr) {
            return -2;  // sequence data before the first header
        } else {
            Py_ssize_t j = i;
            while (j < n && p[j] != '\n') ++j;
            Py_ssize_t e = j;
            while (e > i && (p[e - 1] == '\r' || p[e - 1] == ' ')) --e;
            size_t base = cur->encoded.size();
            cur->encoded.resize(base + (e - i));
            uint8_t* dst = (uint8_t*)cur->encoded.data() + base;
            encode_into(p + i, e - i, lut, /*lossy=*/true, dflt, dst);
            i = j + 1;
        }
    }
    return 0;
}

static PyObject* py_parse_fasta(PyObject*, PyObject* args) {
    Py_buffer data, lut;
    int dflt = 0;
    if (!PyArg_ParseTuple(args, "y*y*i", &data, &lut, &dflt)) return nullptr;
    if (lut.len < 256) {
        PyBuffer_Release(&data);
        PyBuffer_Release(&lut);
        PyErr_SetString(PyExc_ValueError, "lut must have 256 entries");
        return nullptr;
    }
    std::vector<FastaRecord> records;
    int rc = 0;
    Py_BEGIN_ALLOW_THREADS
    rc = parse_fasta_impl((const uint8_t*)data.buf, data.len,
                          (const uint8_t*)lut.buf, (uint8_t)dflt, records);
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&data);
    PyBuffer_Release(&lut);
    if (rc == -2) {
        PyErr_SetString(PyExc_ValueError, "FASTA data before first header");
        return nullptr;
    }
    PyObject* list = PyList_New((Py_ssize_t)records.size());
    if (!list) return nullptr;
    for (size_t r = 0; r < records.size(); ++r) {
        const FastaRecord& rec = records[r];
        PyObject* desc = rec.desc.empty()
                             ? (Py_INCREF(Py_None), Py_None)
                             : PyUnicode_FromStringAndSize(rec.desc.data(),
                                                           rec.desc.size());
        PyObject* tup = Py_BuildValue(
            "(s#Ny#)", rec.name.data(), (Py_ssize_t)rec.name.size(), desc,
            rec.encoded.data(), (Py_ssize_t)rec.encoded.size());
        if (!tup) {
            Py_DECREF(list);
            return nullptr;
        }
        PyList_SET_ITEM(list, (Py_ssize_t)r, tup);
    }
    return list;
}

static PyObject* py_count_symbols(PyObject*, PyObject* args) {
    Py_buffer data;
    int k = 0;
    if (!PyArg_ParseTuple(args, "y*i", &data, &k)) return nullptr;
    if (k <= 0 || k > 255) {
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError, "k out of range");
        return nullptr;
    }
    long long counts[256] = {0};
    Py_BEGIN_ALLOW_THREADS
    const uint8_t* p = (const uint8_t*)data.buf;
    for (Py_ssize_t i = 0; i < data.len; ++i) counts[p[i]]++;
    Py_END_ALLOW_THREADS
    PyBuffer_Release(&data);
    PyObject* list = PyList_New(k);
    if (!list) return nullptr;
    for (int i = 0; i < k; ++i) {
        PyList_SET_ITEM(list, i, PyLong_FromLongLong(counts[i]));
    }
    return list;
}

static PyMethodDef methods[] = {
    {"encode", py_encode, METH_VARARGS,
     "encode(data, lut, lossy, default) -> bytes"},
    {"parse_fasta", py_parse_fasta, METH_VARARGS,
     "parse_fasta(data, lut, default) -> list[(name, desc, encoded)]"},
    {"count_symbols", py_count_symbols, METH_VARARGS,
     "count_symbols(encoded, k) -> list[int]"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_lightmotif_native",
    "Native host runtime (encoding, FASTA ingestion).", -1, methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__lightmotif_native(void) {
    return PyModule_Create(&moduledef);
}
