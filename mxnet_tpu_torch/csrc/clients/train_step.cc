/*
 * Training through the port's general C API from C++ (bindings/cpp/
 * mxtpu.hpp over src/mxtpu_capi.h): a symbol from its JSON, bound with
 * MXExecutorSimpleBind on the CPU (dev_type 1) or the card (2), the
 * given weights, data and labels copied in, then `steps` rounds of
 * forward(is_train) + backward with every weight updated in place by
 * MXImperativeInvoke("sgd_update") where it lives, on the card for
 * dev_type 2.  The first step's gradients are written out for a
 * comparison with the Python executor.
 *
 *   train_step SYMBOL.json WEIGHTS.f32 DATA.f32 LABEL.f32 GRADS_OUT.f32
 *              DEV_TYPE STEPS LR RESCALE N C H W
 *
 * WEIGHTS and GRADS_OUT hold the float32 values of every argument but
 * `data` and `softmax_label`, in the symbol's list_arguments order, each
 * in its logical (NCHW) layout.  Prints one line a step (its ms, from
 * the forward to the last update's completion, MXNDArrayWaitAll
 * included, and the batch's cross-entropy) and TRAIN STEP OK.
 */
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <iterator>
#include <sstream>
#include <string>
#include <vector>

#include "mxtpu.hpp"

using mxtpu::Device;
using mxtpu::Executor;
using mxtpu::NDArray;
using mxtpu::Symbol;

namespace {

std::vector<float> ReadFloats(const char *path) {
  std::ifstream f(path, std::ios::binary);
  std::vector<char> raw((std::istreambuf_iterator<char>(f)),
                        std::istreambuf_iterator<char>());
  std::vector<float> out(raw.size() / sizeof(float));
  std::copy(raw.begin(), raw.begin() + out.size() * sizeof(float),
            reinterpret_cast<char *>(out.data()));
  return out;
}

}  // namespace

int main(int argc, char **argv) {
  if (argc != 14) {
    std::fprintf(stderr, "usage: see the header of train_step.cc\n");
    return 2;
  }
  std::ifstream js(argv[1]);
  std::stringstream json;
  json << js.rdbuf();
  const auto weights = ReadFloats(argv[2]);
  const auto data = ReadFloats(argv[3]);
  const auto label = ReadFloats(argv[4]);
  const int dev_type = std::atoi(argv[6]);
  const int steps = std::atoi(argv[7]);
  const std::string lr = argv[8], rescale = argv[9];
  const uint32_t n = std::atoi(argv[10]), c = std::atoi(argv[11]),
                 h = std::atoi(argv[12]), w = std::atoi(argv[13]);
  try {
    auto net = Symbol::FromJSON(json.str());
    Executor exec(net, static_cast<Device>(dev_type), "write",
                  {{"data", {n, c, h, w}}, {"softmax_label", {n}}});
    std::vector<std::string> params;
    size_t off = 0;
    for (auto &name : net.ListArguments()) {
      if (name == "data" || name == "softmax_label") continue;
      auto arr = exec.Arg(name);
      const size_t size = arr.Size();
      if (off + size > weights.size()) throw std::runtime_error("weights");
      arr.CopyFrom(std::vector<float>(weights.begin() + off,
                                      weights.begin() + off + size));
      off += size;
      params.push_back(name);
    }
    if (off != weights.size()) throw std::runtime_error("extra weights");
    exec.Arg("data").CopyFrom(data);
    exec.Arg("softmax_label").CopyFrom(label);

    const char *keys[] = {"lr", "rescale_grad"};
    const char *vals[] = {lr.c_str(), rescale.c_str()};
    for (int step = 0; step < steps; ++step) {
      auto t0 = std::chrono::steady_clock::now();
      exec.Forward(true);
      exec.Backward();
      if (step == 0) {
        std::ofstream out(argv[5], std::ios::binary);
        for (auto &name : params) {
          auto g = exec.Grad(name).CopyTo();
          out.write(reinterpret_cast<const char *>(g.data()),
                    g.size() * sizeof(float));
        }
      }
      for (auto &name : params) {
        auto wt = exec.Arg(name);
        auto gr = exec.Grad(name);
        NDArrayHandle in[2] = {wt.handle(), gr.handle()};
        NDArrayHandle outs[1] = {nullptr};
        uint32_t num_out = 0;
        mxtpu::check(MXImperativeInvoke("sgd_update", 2, in, 2, keys, vals,
                                        1, &num_out, outs),
                     "ImperativeInvoke(sgd_update)");
        // the update wrote the bound weight; its handle is a new view
        MXNDArrayFree(outs[0]);
      }
      mxtpu::check(MXNDArrayWaitAll(), "WaitAll");
      double ms = std::chrono::duration<double, std::milli>(
                      std::chrono::steady_clock::now() - t0).count();
      auto probs = exec.Output(0).CopyTo();
      const size_t classes = probs.size() / n;
      double loss = 0;
      for (uint32_t i = 0; i < n; ++i) {
        double p = probs[i * classes + static_cast<size_t>(label[i])];
        loss -= std::log(p > 1e-12 ? p : 1e-12);
      }
      std::printf("step %d ms %.3f loss %.6f\n", step, ms, loss / n);
      std::fflush(stdout);
    }
  } catch (const std::exception &e) {
    std::fprintf(stderr, "%s\n", e.what());
    return 1;
  }
  std::printf("TRAIN STEP OK\n");
  return 0;
}
