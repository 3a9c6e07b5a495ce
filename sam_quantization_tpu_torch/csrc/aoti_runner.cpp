// Python-free consumer of the port's AOTInductor packages.
//
// Loads a package written by export.export_decoder_aoti or
// export.export_encoder_aoti (model.pt2, compiled for the CPU or a CUDA
// card) through libtorch's AOTIModelPackageLoader and runs it on raw
// float32 tensors: the same command line and file protocol as the JAX
// package's csrc/savedmodel_runner.cpp.
//
// Usage:
//   aoti_runner <package_dir> <input_dir> <output_dir>
//
// It computes in float32, with TF32 off.
//
// <package_dir>/manifest.txt lists the program's tensors in call order:
//   in  <key> <position>     e.g.  in image_embeddings 0
//   out <key> <position>
// Each input is read from <input_dir>/<key>.bin (raw float32, C order) with
// its shape in <input_dir>/<key>.shape (ASCII dims, space-separated) and
// moved to the package's device. Each output is written to
// <output_dir>/<key>.bin + .shape in the same format.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <string>
#include <vector>

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>

namespace {

struct TensorSpec {
  std::string key;
  size_t position = 0;
};

void Fail(const std::string& msg) {
  std::fprintf(stderr, "aoti_runner: %s\n", msg.c_str());
  std::exit(1);
}

std::vector<int64_t> ReadShape(const std::string& path) {
  std::ifstream f(path);
  if (!f) Fail("cannot open " + path);
  std::vector<int64_t> dims;
  int64_t d;
  while (f >> d) dims.push_back(d);
  return dims;
}

at::Tensor ReadTensor(const std::string& stem) {
  auto dims = ReadShape(stem + ".shape");
  at::Tensor t = at::empty(dims, at::kFloat);
  const auto bytes = static_cast<std::streamsize>(t.numel() * sizeof(float));
  std::ifstream f(stem + ".bin", std::ios::binary);
  if (!f) Fail("cannot open " + stem + ".bin");
  f.read(reinterpret_cast<char*>(t.data_ptr<float>()), bytes);
  if (f.gcount() != bytes) Fail("short read from " + stem + ".bin");
  return t;
}

void WriteTensor(const std::string& stem, const at::Tensor& value) {
  at::Tensor t = value.to(at::kCPU).to(at::kFloat).contiguous();
  std::ofstream shape(stem + ".shape");
  for (int64_t i = 0; i < t.dim(); ++i) shape << (i ? " " : "") << t.size(i);
  std::ofstream f(stem + ".bin", std::ios::binary);
  f.write(reinterpret_cast<const char*>(t.data_ptr<float>()),
          static_cast<std::streamsize>(t.numel() * sizeof(float)));
  if (!shape || !f) Fail("cannot write " + stem);
}

}  // namespace

int main(int argc, char** argv) {
  if (argc != 4) {
    std::fprintf(stderr, "usage: %s <package_dir> <input_dir> <output_dir>\n",
                 argv[0]);
    return 2;
  }
  const std::string package_dir = argv[1];
  const std::string input_dir = argv[2];
  const std::string output_dir = argv[3];

  std::vector<TensorSpec> inputs, outputs;
  {
    std::ifstream mf(package_dir + "/manifest.txt");
    if (!mf) Fail("missing manifest.txt in " + package_dir);
    std::string kind, key;
    size_t position;
    while (mf >> kind >> key >> position) {
      if (kind == "in") inputs.push_back({key, position});
      else if (kind == "out") outputs.push_back({key, position});
      else Fail("bad manifest line kind " + kind);
    }
  }
  if (inputs.empty() || outputs.empty()) Fail("empty manifest");

  // The exported programs compute in float32: no TF32 in cuBLAS or cuDNN
  // (libtorch allows it in cuDNN's convolutions by default).
  at::globalContext().setAllowTF32CuBLAS(false);
  at::globalContext().setAllowTF32CuDNN(false);
  try {
    torch::inductor::AOTIModelPackageLoader loader(package_dir + "/model.pt2");
    const auto metadata = loader.get_metadata();
    const auto found = metadata.find("AOTI_DEVICE_KEY");
    const c10::Device device(found == metadata.end() ? "cpu" : found->second);

    std::vector<at::Tensor> feeds(inputs.size());
    for (const auto& spec : inputs) {
      if (spec.position >= feeds.size()) Fail("input position out of range: " + spec.key);
      feeds[spec.position] = ReadTensor(input_dir + "/" + spec.key).to(device);
    }
    std::vector<at::Tensor> results = loader.run(feeds);
    for (const auto& spec : outputs) {
      if (spec.position >= results.size()) Fail("output position out of range: " + spec.key);
      WriteTensor(output_dir + "/" + spec.key, results[spec.position]);
    }
  } catch (const std::exception& e) {
    Fail(e.what());
  }
  return 0;
}
