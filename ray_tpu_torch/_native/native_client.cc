// Native (C++) client for ray_tpu_torch — the C++ worker-API equivalent.
//
// Reference: cpp/src/ray/ (the C++ worker frontend) and the cross-language
// call path (Java/C++ workers invoking Python functions by module path).
// Python stays the only task *execution* language (tasks drive PyTorch
// and the hand-written CUDA kernels; a native executor would buy nothing
// on the compute path), so the native frontend is a thin, dependency-free
// client for the head's HTTP/JSON gateway (ray_tpu_torch/dashboard/head.py):
//
//   rt_call(host, port, body_json)   -> POST /api/call   (run module:attr)
//   rt_submit_job(host, port, body)  -> POST /api/jobs   (entrypoint cmd)
//   rt_get(host, port, path)         -> GET  any state route
//
// All functions return a malloc'd NUL-terminated response body (JSON);
// the caller frees it with rt_free. NULL on connect/IO failure. Blocking,
// one TCP connection per call (the gateway is synchronous anyway).
//
// Build: compiled on first use by ray_tpu_torch._native.load_library (one
// g++ -shared into build/torch_ext/, as the object store); usable from any
// C/C++ program by linking the same .so. It is host code, no CUDA kernel.

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

namespace {

int connect_to(const char* host, int port) {
  struct addrinfo hints;
  std::memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  char portbuf[16];
  std::snprintf(portbuf, sizeof(portbuf), "%d", port);
  struct addrinfo* res = nullptr;
  if (getaddrinfo(host, portbuf, &hints, &res) != 0 || res == nullptr) {
    return -1;
  }
  int fd = -1;
  for (struct addrinfo* ai = res; ai != nullptr; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd >= 0) {
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  }
  return fd;
}

bool send_all(int fd, const char* buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t k = send(fd, buf + off, n - off, 0);
    if (k <= 0) return false;
    off += static_cast<size_t>(k);
  }
  return true;
}

// Reads the whole HTTP/1.1 response (Content-Length framing; the head
// always sets it) and returns a malloc'd copy of the body.
char* read_response(int fd) {
  std::string data;
  char buf[8192];
  size_t header_end = std::string::npos;
  long content_len = -1;
  for (;;) {
    ssize_t k = recv(fd, buf, sizeof(buf), 0);
    if (k < 0) return nullptr;
    if (k == 0) break;
    data.append(buf, static_cast<size_t>(k));
    if (header_end == std::string::npos) {
      header_end = data.find("\r\n\r\n");
      if (header_end != std::string::npos) {
        // parse Content-Length (case-insensitive)
        std::string lower;
        lower.reserve(header_end);
        for (size_t i = 0; i < header_end; i++)
          lower.push_back(static_cast<char>(tolower(data[i])));
        size_t p = lower.find("content-length:");
        if (p != std::string::npos) {
          content_len = std::strtol(data.c_str() + p + 15, nullptr, 10);
        }
      }
    }
    if (header_end != std::string::npos && content_len >= 0 &&
        data.size() >= header_end + 4 + static_cast<size_t>(content_len)) {
      break;
    }
  }
  if (header_end == std::string::npos) return nullptr;
  std::string body = data.substr(header_end + 4);
  if (content_len >= 0 && body.size() > static_cast<size_t>(content_len)) {
    body.resize(static_cast<size_t>(content_len));
  }
  char* out = static_cast<char*>(std::malloc(body.size() + 1));
  if (out == nullptr) return nullptr;
  std::memcpy(out, body.data(), body.size());
  out[body.size()] = '\0';
  return out;
}

char* request(const char* host, int port, const char* method,
              const char* path, const char* body) {
  int fd = connect_to(host, port);
  if (fd < 0) return nullptr;
  size_t blen = body ? std::strlen(body) : 0;
  std::string req;
  req.reserve(256 + blen);
  req += method;
  req += " ";
  req += path;
  req += " HTTP/1.1\r\nHost: ";
  req += host;
  req += "\r\nConnection: close\r\nContent-Type: application/json\r\n";
  char lenbuf[64];
  std::snprintf(lenbuf, sizeof(lenbuf), "Content-Length: %zu\r\n\r\n", blen);
  req += lenbuf;
  if (blen) req.append(body, blen);
  char* out = nullptr;
  if (send_all(fd, req.data(), req.size())) out = read_response(fd);
  close(fd);
  return out;
}

}  // namespace

extern "C" {

// GET any route, e.g. "/api/nodes", "/api/jobs/job-0001".
char* rt_get(const char* host, int port, const char* path) {
  return request(host, port, "GET", path, nullptr);
}

// POST a JSON body to any route.
char* rt_post(const char* host, int port, const char* path,
              const char* json_body) {
  return request(host, port, "POST", path, json_body);
}

// Run a Python callable as a cluster task and return the gateway's JSON
// response ({"result": ...} or {"error": ...}).
// json_body: {"func": "module:attr", "args": [...], "kwargs": {...}}
char* rt_call(const char* host, int port, const char* json_body) {
  return request(host, port, "POST", "/api/call", json_body);
}

// Submit a job entrypoint: {"entrypoint": "python my_driver.py"}.
char* rt_submit_job(const char* host, int port, const char* json_body) {
  return request(host, port, "POST", "/api/jobs", json_body);
}

void rt_free(char* p) { std::free(p); }

}  // extern "C"
