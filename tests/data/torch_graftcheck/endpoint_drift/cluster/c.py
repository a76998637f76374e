def call(post, w):
    post(w + "/worker/phantom")
    post(w + "/worker/served")


def orphan(post, w):
    post(w + "/worker/ghost")
