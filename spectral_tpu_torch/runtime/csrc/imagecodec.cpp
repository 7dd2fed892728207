// Native image codec for the spectral_tpu runtime.
//
// The reference app leans on the native Rust `image` crate for its
// framebuffer -> file path (reference src/custom_image.rs:92-101,
// src/main.rs:2313-2331). This is the equivalent native component for the
// TPU framework's host runtime: multithreaded float32-RGBA -> u8
// conversion (clamp to [0,1], scale by 255, truncate toward zero — the
// same semantics as Rust's `as u8` on the clamped float) and a PNG
// encoder (zlib deflate, filter type 0), exposed over a C ABI for ctypes.
//
// Build: g++ -O3 -shared -fPIC imagecodec.cpp -o libimagecodec.so -lz -lpthread

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// Clamp-scale-truncate conversion, parallelized across hardware threads.
void convert_f32_rgba_to_u8(const float* src, uint8_t* dst, int64_t count) {
    const int64_t kMinPerThread = 1 << 16;
    unsigned hw = std::thread::hardware_concurrency();
    int64_t want = count / kMinPerThread;
    unsigned n_threads = 1;
    if (hw > 1 && want > 1) {
        n_threads = static_cast<unsigned>(want < hw ? want : hw);
    }

    auto work = [src, dst](int64_t begin, int64_t end) {
        for (int64_t i = begin; i < end; ++i) {
            float v = src[i];
            if (!(v > 0.0f)) v = 0.0f;  // NaN -> 0, like Rust clamp+cast
            if (v > 1.0f) v = 1.0f;
            dst[i] = static_cast<uint8_t>(v * 255.0f);
        }
    };

    if (n_threads == 1) {
        work(0, count);
        return;
    }
    std::vector<std::thread> threads;
    int64_t chunk = (count + n_threads - 1) / n_threads;
    for (unsigned t = 0; t < n_threads; ++t) {
        int64_t begin = static_cast<int64_t>(t) * chunk;
        int64_t end = begin + chunk < count ? begin + chunk : count;
        if (begin >= end) break;
        threads.emplace_back(work, begin, end);
    }
    for (auto& th : threads) th.join();
}

namespace {

void put_be32(std::vector<uint8_t>& out, uint32_t v) {
    out.push_back(static_cast<uint8_t>(v >> 24));
    out.push_back(static_cast<uint8_t>(v >> 16));
    out.push_back(static_cast<uint8_t>(v >> 8));
    out.push_back(static_cast<uint8_t>(v));
}

void put_chunk(std::vector<uint8_t>& out, const char type[4],
               const uint8_t* data, size_t len) {
    put_be32(out, static_cast<uint32_t>(len));
    size_t start = out.size();
    out.insert(out.end(), type, type + 4);
    if (len) out.insert(out.end(), data, data + len);
    uint32_t crc = crc32(0L, Z_NULL, 0);
    crc = crc32(crc, out.data() + start, static_cast<uInt>(4 + len));
    put_be32(out, crc);
}

}  // namespace

// Encode RGBA8 pixels as a PNG. Returns a malloc'd buffer the caller
// frees with free_buffer; returns null on failure.
uint8_t* encode_png_rgba(const uint8_t* rgba, int32_t width, int32_t height,
                         int64_t* out_len) {
    if (width <= 0 || height <= 0) return nullptr;
    const size_t stride = static_cast<size_t>(width) * 4;

    // raw stream: one filter byte (0 = None) per scanline
    std::vector<uint8_t> raw;
    raw.reserve((stride + 1) * height);
    for (int32_t y = 0; y < height; ++y) {
        raw.push_back(0);
        raw.insert(raw.end(), rgba + y * stride, rgba + (y + 1) * stride);
    }

    uLongf bound = compressBound(static_cast<uLong>(raw.size()));
    std::vector<uint8_t> compressed(bound);
    if (compress2(compressed.data(), &bound, raw.data(),
                  static_cast<uLong>(raw.size()), 6) != Z_OK) {
        return nullptr;
    }
    compressed.resize(bound);

    std::vector<uint8_t> png;
    png.reserve(compressed.size() + 128);
    static const uint8_t kSig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
    png.insert(png.end(), kSig, kSig + 8);

    uint8_t ihdr[13];
    ihdr[0] = static_cast<uint8_t>(width >> 24);
    ihdr[1] = static_cast<uint8_t>(width >> 16);
    ihdr[2] = static_cast<uint8_t>(width >> 8);
    ihdr[3] = static_cast<uint8_t>(width);
    ihdr[4] = static_cast<uint8_t>(height >> 24);
    ihdr[5] = static_cast<uint8_t>(height >> 16);
    ihdr[6] = static_cast<uint8_t>(height >> 8);
    ihdr[7] = static_cast<uint8_t>(height);
    ihdr[8] = 8;   // bit depth
    ihdr[9] = 6;   // color type RGBA
    ihdr[10] = 0;  // compression
    ihdr[11] = 0;  // filter
    ihdr[12] = 0;  // interlace
    put_chunk(png, "IHDR", ihdr, sizeof(ihdr));
    put_chunk(png, "IDAT", compressed.data(), compressed.size());
    put_chunk(png, "IEND", nullptr, 0);

    uint8_t* out = static_cast<uint8_t*>(std::malloc(png.size()));
    if (!out) return nullptr;
    std::memcpy(out, png.data(), png.size());
    *out_len = static_cast<int64_t>(png.size());
    return out;
}

void free_buffer(uint8_t* p) { std::free(p); }

}  // extern "C"
