// gsplat_native: fast data-path kernels for the TPU gaussian-splatting
// framework — the C++ equivalent of the reference's hot JS loops:
//   * gaussian-PLY parse into columnar float arrays
//     (gaussians_selection.js:464-585 parses into a packed buffer)
//   * importance ordering exp(sx+sy+sz)*sigmoid(opacity) (js:513-528)
//   * 32-byte .splat row packing with u8 quantization (js:536-576)
// Exposed as a C ABI for ctypes (no pybind11 in this environment).
//
// Build: make -C native   (produces libgsplat_native.so)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Property {
    std::string name;
    int type_size;   // bytes
    char kind;       // 'f' float, 'd' double, 'i' int, 'u' uint (by size)
    size_t offset;   // byte offset within a row
};

struct Header {
    size_t vertex_count = 0;
    size_t data_offset = 0;
    size_t row_stride = 0;
    bool binary_le = false;
    std::vector<Property> props;
};

int type_info(const std::string& t, int* size, char* kind) {
    if (t == "float" || t == "float32") { *size = 4; *kind = 'f'; return 0; }
    if (t == "double" || t == "float64") { *size = 8; *kind = 'd'; return 0; }
    if (t == "int" || t == "int32") { *size = 4; *kind = 'i'; return 0; }
    if (t == "uint" || t == "uint32") { *size = 4; *kind = 'u'; return 0; }
    if (t == "short" || t == "int16") { *size = 2; *kind = 'i'; return 0; }
    if (t == "ushort" || t == "uint16") { *size = 2; *kind = 'u'; return 0; }
    if (t == "char" || t == "int8") { *size = 1; *kind = 'i'; return 0; }
    if (t == "uchar" || t == "uint8") { *size = 1; *kind = 'u'; return 0; }
    return -1;
}

int parse_header(const uint8_t* data, size_t len, Header* h) {
    static const char kEnd[] = "end_header\n";
    const char* p = reinterpret_cast<const char*>(data);
    size_t limit = std::min(len, size_t(64 * 1024));
    std::string head(p, limit);
    size_t end = head.find(kEnd);
    if (end == std::string::npos || head.compare(0, 3, "ply") != 0) return -1;
    h->data_offset = end + sizeof(kEnd) - 1;

    size_t pos = 0, offset = 0;
    bool in_vertex = false;
    while (pos < end) {
        size_t eol = head.find('\n', pos);
        if (eol == std::string::npos || eol > end) eol = end;
        std::string line = head.substr(pos, eol - pos);
        pos = eol + 1;
        if (line.rfind("format ", 0) == 0) {
            h->binary_le = line.find("binary_little_endian") != std::string::npos;
        } else if (line.rfind("element ", 0) == 0) {
            in_vertex = line.find("vertex") != std::string::npos;
            if (in_vertex) {
                size_t sp = line.rfind(' ');
                h->vertex_count = std::stoull(line.substr(sp + 1));
            }
        } else if (in_vertex && line.rfind("property ", 0) == 0) {
            size_t a = line.find(' ', 9);
            if (a == std::string::npos) return -2;
            std::string type = line.substr(9, a - 9);
            if (type == "list") return -3;  // lists unsupported
            std::string name = line.substr(a + 1);
            Property prop;
            prop.name = name;
            if (type_info(type, &prop.type_size, &prop.kind) != 0) return -4;
            prop.offset = offset;
            offset += prop.type_size;
            h->props.push_back(prop);
        }
    }
    h->row_stride = offset;
    if (!h->binary_le) return -5;  // ascii handled by the Python codec
    if (h->data_offset + h->vertex_count * h->row_stride > len) return -6;
    return 0;
}

inline float read_as_float(const uint8_t* p, const Property& prop) {
    switch (prop.kind) {
        case 'f': { float v; std::memcpy(&v, p, 4); return v; }
        case 'd': { double v; std::memcpy(&v, p, 8); return float(v); }
        case 'i':
            if (prop.type_size == 4) { int32_t v; std::memcpy(&v, p, 4); return float(v); }
            if (prop.type_size == 2) { int16_t v; std::memcpy(&v, p, 2); return float(v); }
            { int8_t v; std::memcpy(&v, p, 1); return float(v); }
        case 'u':
            if (prop.type_size == 4) { uint32_t v; std::memcpy(&v, p, 4); return float(v); }
            if (prop.type_size == 2) { uint16_t v; std::memcpy(&v, p, 2); return float(v); }
            { uint8_t v; std::memcpy(&v, p, 1); return float(v); }
    }
    return 0.0f;
}

void parallel_for(size_t n, const std::function<void(size_t, size_t)>& fn) {
    unsigned hw = std::max(1u, std::thread::hardware_concurrency());
    unsigned workers = std::min<size_t>(hw, 16);
    if (n < 65536 || workers <= 1) { fn(0, n); return; }
    std::vector<std::thread> threads;
    size_t per = (n + workers - 1) / workers;
    for (unsigned w = 0; w < workers; ++w) {
        size_t lo = w * per, hi = std::min(n, lo + per);
        if (lo >= hi) break;
        threads.emplace_back(fn, lo, hi);
    }
    for (auto& t : threads) t.join();
}

}  // namespace

extern "C" {

// Probe a gaussian PLY: fills counts/flags. Returns 0 on success, negative
// error codes from parse_header otherwise.
int gsplat_ply_probe(const uint8_t* data, size_t len, int64_t* n_vertices,
                     int32_t* sh_bands, int32_t* has_label,
                     int32_t* has_normals) {
    Header h;
    int rc = parse_header(data, len, &h);
    if (rc != 0) return rc;
    int rest = 0;
    *has_label = 0;
    *has_normals = 0;
    for (const auto& p : h.props) {
        if (p.name == "label") *has_label = 1;
        if (p.name == "nx") *has_normals = 1;
        if (p.name.rfind("f_rest_", 0) == 0) rest++;
    }
    *n_vertices = int64_t(h.vertex_count);
    *sh_bands = 1 + rest / 3;
    return 0;
}

// Extract a gaussian PLY into caller-allocated columnar arrays.
// sh is [n, sh_bands, 3] with the standard channel-major f_rest layout.
// Any missing property column is left untouched. Multithreaded.
int gsplat_ply_extract(const uint8_t* data, size_t len,
                       float* means, float* log_scales, float* quats,
                       float* opacities, float* sh, int32_t sh_bands,
                       int32_t* labels) {
    Header h;
    int rc = parse_header(data, len, &h);
    if (rc != 0) return rc;

    // map wanted property names -> destination (array, column, width)
    struct Dst { float* arr; int col; int width; };
    std::vector<std::pair<const Property*, Dst>> cols;
    std::vector<const Property*> label_prop;
    auto find = [&](const std::string& name) -> const Property* {
        for (const auto& p : h.props) if (p.name == name) return &p;
        return nullptr;
    };
    const char* xyz[3] = {"x", "y", "z"};
    for (int i = 0; i < 3; ++i) {
        if (auto* p = find(xyz[i])) cols.push_back({p, {means, i, 3}});
        if (auto* p = find("scale_" + std::to_string(i)))
            cols.push_back({p, {log_scales, i, 3}});
        if (auto* p = find("f_dc_" + std::to_string(i)))
            cols.push_back({p, {sh, i, sh_bands * 3}});
    }
    for (int i = 0; i < 4; ++i)
        if (auto* p = find("rot_" + std::to_string(i)))
            cols.push_back({p, {quats, i, 4}});
    if (auto* p = find("opacity")) cols.push_back({p, {opacities, 0, 1}});
    // f_rest_i: channel-major [3, bands-1] -> sh[:, 1 + i % (bands-1),
    //                                            i / (bands-1)]
    int hi = sh_bands - 1;
    for (int i = 0; i < hi * 3; ++i) {
        if (auto* p = find("f_rest_" + std::to_string(i))) {
            int band = 1 + (i % hi), chan = i / hi;
            cols.push_back({p, {sh, band * 3 + chan, sh_bands * 3}});
        }
    }
    const Property* lab = find("label");

    const uint8_t* base = data + h.data_offset;
    size_t stride = h.row_stride;
    parallel_for(h.vertex_count, [&](size_t lo, size_t hi_row) {
        for (size_t r = lo; r < hi_row; ++r) {
            const uint8_t* row = base + r * stride;
            for (const auto& [p, d] : cols)
                d.arr[r * d.width + d.col] = read_as_float(row + p->offset, *p);
            if (lab && labels) {
                int32_t v;
                if (lab->kind == 'i' && lab->type_size == 4)
                    std::memcpy(&v, row + lab->offset, 4);
                else
                    v = int32_t(read_as_float(row + lab->offset, *lab));
                labels[r] = v;
            }
        }
    });
    return 0;
}

// Importance order (descending exp(sum log_scales) * sigmoid(opacity),
// stable) — the reference's initial sort (js:513-528).
void gsplat_importance_order(const float* log_scales, const float* opacities,
                             int64_t n, int32_t* order_out) {
    std::vector<float> key(n);
    parallel_for(size_t(n), [&](size_t lo, size_t hi) {
        for (size_t i = lo; i < hi; ++i) {
            float vol = std::exp(log_scales[i * 3] + log_scales[i * 3 + 1]
                                 + log_scales[i * 3 + 2]);
            key[i] = vol / (1.0f + std::exp(-opacities[i]));
        }
    });
    for (int64_t i = 0; i < n; ++i) order_out[i] = int32_t(i);
    std::stable_sort(order_out, order_out + n,
                     [&](int32_t a, int32_t b) { return key[a] > key[b]; });
}

// Pack rows into the 32-byte .splat layout in the given order (js:536-576).
void gsplat_pack_splat(const float* means, const float* log_scales,
                       const float* quats, const float* opacities,
                       const float* sh_dc, const int32_t* order, int64_t n,
                       uint8_t* out) {
    const float kSH0 = 0.28209479177387814f;
    parallel_for(size_t(n), [&](size_t lo, size_t hi) {
        for (size_t r = lo; r < hi; ++r) {
            int64_t i = order ? order[r] : int64_t(r);
            uint8_t* row = out + r * 32;
            float pos[3], scl[3];
            for (int k = 0; k < 3; ++k) {
                pos[k] = means[i * 3 + k];
                scl[k] = std::exp(log_scales[i * 3 + k]);
            }
            std::memcpy(row, pos, 12);
            std::memcpy(row + 12, scl, 12);
            float alpha = 1.0f / (1.0f + std::exp(-opacities[i]));
            for (int k = 0; k < 3; ++k) {
                float c = 0.5f + kSH0 * sh_dc[i * 3 + k];
                row[24 + k] = uint8_t(std::min(255.0f,
                                               std::max(0.0f, c * 255.0f)));
            }
            row[27] = uint8_t(std::min(255.0f, std::max(0.0f, alpha * 255.0f)));
            float q[4], nrm = 0.0f;
            for (int k = 0; k < 4; ++k) { q[k] = quats[i * 4 + k]; nrm += q[k] * q[k]; }
            nrm = std::sqrt(std::max(nrm, 1e-24f));
            for (int k = 0; k < 4; ++k) {
                float v = q[k] / nrm * 128.0f + 128.0f;
                row[28 + k] = uint8_t(std::min(255.0f, std::max(0.0f, v)));
            }
        }
    });
}

// Write a labeled binary-LE gaussian PLY (the deep_learning_segmentation.py
// save path, py:311-332) straight from columnar arrays.
// Layout: x y z [nx ny nz=0] f_dc*3 f_rest*(3*(bands-1)) opacity scale*3
// rot*4 [label]. Returns bytes written (call with out=null to size).
int64_t gsplat_write_gaussian_rows(
    const float* means, const float* log_scales, const float* quats,
    const float* opacities, const float* sh, int32_t sh_bands,
    const int32_t* labels, int64_t n, int32_t with_normals, uint8_t* out) {
    int hi = sh_bands - 1;
    size_t floats = 3 + (with_normals ? 3 : 0) + 3 + 3 * hi + 1 + 3 + 4;
    size_t stride = floats * 4 + (labels ? 4 : 0);
    if (!out) return int64_t(stride * n);
    parallel_for(size_t(n), [&](size_t lo, size_t hi_row) {
        for (size_t r = lo; r < hi_row; ++r) {
            uint8_t* row = out + r * stride;
            size_t off = 0;
            auto put = [&](float v) { std::memcpy(row + off, &v, 4); off += 4; };
            for (int k = 0; k < 3; ++k) put(means[r * 3 + k]);
            if (with_normals) for (int k = 0; k < 3; ++k) put(0.0f);
            for (int k = 0; k < 3; ++k) put(sh[(r * sh_bands) * 3 + k]);
            for (int c = 0; c < 3; ++c)       // channel-major f_rest
                for (int b = 1; b < sh_bands; ++b)
                    put(sh[(r * sh_bands + b) * 3 + c]);
            put(opacities[r]);
            for (int k = 0; k < 3; ++k) put(log_scales[r * 3 + k]);
            for (int k = 0; k < 4; ++k) put(quats[r * 4 + k]);
            if (labels) { std::memcpy(row + off, &labels[r], 4); off += 4; }
        }
    });
    return int64_t(stride * n);
}

}  // extern "C"
